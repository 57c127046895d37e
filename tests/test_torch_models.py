"""The port's modules vs the JAX package's flax modules on the same seeded
inputs, with the flax parameters carried across by ``flax_to_torch``
(strict ``load_state_dict``, so every parameter is mapped).

fp32 on the CPU. Tolerance 2e-4 absolute and relative: the two frameworks
sum in different orders, and flax's LayerNorm/GroupNorm take the fast
variance (E[x^2] - E[x]^2) where torch takes the two-pass one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from hivae_tpu.models import amd as jamd
from hivae_tpu.models import blocks as jblocks
from hivae_tpu.models import dit as jdit
from hivae_tpu.models import motion_encoders as jenc
from hivae_tpu.models import vae as jvae
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import blocks as tblocks
from hivae_tpu_torch.models import dit as tdit
from hivae_tpu_torch.models import motion_encoders as tenc
from hivae_tpu_torch.models import vae as tvae
from hivae_tpu_torch.utils.params import flax_to_torch

TOL = dict(atol=2e-4, rtol=2e-4)
KEY = jax.random.PRNGKey(0)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _perturb(params, seed=0):
    """flax inits zero biases, unit norms and zero tokens: perturb every
    leaf so a mis-mapped parameter cannot hide behind its init value."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*np.shape(x)).astype(
            np.float32), params)


def _port(flax_params, module):
    module.load_state_dict(flax_to_torch(flax_params), strict=True)
    return module.eval()


def _run(jmod, tmod, *arrays, **kw):
    params = _perturb(jax.device_get(jax.jit(jmod.init)(
        KEY, *map(jnp.asarray, arrays), **kw)))
    want = jax.jit(jmod.apply)(params, *map(jnp.asarray, arrays), **kw)
    tmod = _port(params, tmod)
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, arrays), **kw)
    return got, want


def _close(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


DIM, HEADS, HD, COND = 32, 2, 16, 24


@pytest.mark.parametrize("name", ["attention", "cross_attention", "ff",
                                  "basic", "basic_cross", "dit"])
def test_single_stream_blocks(name):
    x = _rand(2, 7, DIM, seed=1)
    ctx = _rand(2, 5, DIM, seed=2)
    temb = _rand(2, COND, seed=3)
    cases = {
        "attention": (jblocks.Attention(DIM, HEADS, HD),
                      tblocks.Attention(DIM, HEADS, HD), (x,)),
        "cross_attention": (jblocks.Attention(DIM, HEADS, HD),
                            tblocks.Attention(DIM, HEADS, HD), (x, ctx)),
        "ff": (jblocks.FeedForward(DIM), tblocks.FeedForward(DIM), (x,)),
        "basic": (jblocks.BasicTransformerBlock(DIM, HEADS, HD),
                  tblocks.BasicTransformerBlock(DIM, HEADS, HD), (x,)),
        "basic_cross": (jblocks.BasicCrossTransformerBlock(DIM, HEADS, HD),
                        tblocks.BasicCrossTransformerBlock(DIM, HEADS, HD),
                        (x, ctx)),
        "dit": (jblocks.DiTBlock(DIM, HEADS, HD),
                tblocks.DiTBlock(DIM, HEADS, HD, COND), (x, temb)),
    }
    jmod, tmod, args = cases[name]
    _close(*_run(jmod, tmod, *args))


@pytest.mark.parametrize("masked", [False, True])
def test_joint_block(masked):
    hidden = _rand(2, 6, DIM, seed=4)
    enc = _rand(2, 9, DIM, seed=5)
    temb = _rand(2, COND, seed=6)
    kw = {}
    if masked:
        keep = np.random.RandomState(7).rand(2, 6) > 0.5
        keep[1] = False
        kw = dict(hidden_key_mask=keep)
    jmod = jblocks.JointTransformerBlock(DIM, HEADS, HD)
    params = _perturb(jax.device_get(jmod.init(
        KEY, jnp.asarray(hidden), jnp.asarray(enc), jnp.asarray(temb),
        **{k: jnp.asarray(v) for k, v in kw.items()})))
    want = jmod.apply(params, jnp.asarray(hidden), jnp.asarray(enc),
                      jnp.asarray(temb),
                      **{k: jnp.asarray(v) for k, v in kw.items()})
    tmod = _port(params, tblocks.JointTransformerBlock(DIM, HEADS, HD, COND))
    with torch.no_grad():
        got = tmod(torch.from_numpy(hidden), torch.from_numpy(enc),
                   torch.from_numpy(temb),
                   **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(got, want)


@pytest.mark.parametrize("name", ["adaln_zero", "adaln_single", "adaln",
                                  "timestep", "patch"])
def test_conditioning_layers(name):
    x = _rand(2, 5, DIM, seed=8)
    e = _rand(2, 3, DIM, seed=9)
    temb = _rand(2, COND, seed=10)
    if name == "adaln_zero":
        _close(*_run(jblocks.AdaLNZero(DIM), tblocks.AdaLNZero(DIM, COND),
                     x, e, temb))
    elif name == "adaln_single":
        _close(*_run(jblocks.AdaLNZeroSingle(DIM),
                     tblocks.AdaLNZeroSingle(DIM, COND), x, temb))
    elif name == "adaln":
        _close(*_run(jblocks.AdaLayerNorm(DIM), tblocks.AdaLayerNorm(DIM, COND),
                     x, temb))
    elif name == "timestep":
        steps = np.array([0.0, 100.0, 999.0], np.float32)
        _close(*_run(jblocks.TimestepEmbedding(DIM, COND),
                     tblocks.TimestepEmbedding(DIM, COND), steps))
    else:
        img = _rand(2, 3, 8, 8, seed=11)
        _close(*_run(jblocks.PatchEmbed(2, DIM), tblocks.PatchEmbed(2, 3, DIM),
                     img))


ENC_KW = dict(img_height=8, img_width=8, img_inchannel=4, img_patch_size=2,
              motion_token_num=4, motion_channel=12, heads=2, head_dim=8,
              num_layers=2)


@pytest.mark.parametrize("norm_out", [False, True])
def test_motion_encoder_spatial(norm_out):
    video = _rand(1, 3, 4, 8, 8, seed=12)
    _close(*_run(jenc.MotionEncoderSpatial(need_norm_out=norm_out, **ENC_KW),
                 tenc.MotionEncoderSpatial(need_norm_out=norm_out, **ENC_KW),
                 video))


@pytest.mark.parametrize("frames,tokens", [(4, 4), (4, 2)])
def test_motion_encoder_temporal_cross(frames, tokens):
    kw = dict(ENC_KW, motion_token_num=tokens, video_frames=frames)
    video = _rand(1, frames, 4, 8, 8, seed=13)
    _close(*_run(jenc.MotionEncoderTemporalCross(need_norm_out=False, **kw),
                 tenc.MotionEncoderTemporalCross(need_norm_out=False, **kw),
                 video))


DIT_KW = dict(heads=2, head_dim=16, out_channels=4, num_layers=2,
              image_height=8, image_width=8, image_patch_size=2,
              image_in_channels=8, motion_token_num=3,
              camera_motion_in_channels=6, object_motion_in_channels=10,
              motion_target_num_frame=2)


@pytest.mark.parametrize("scan", [False, True])
def test_velocity_dit(scan):
    """The unrolled flax tree and the ``nn.scan``-stacked one (the flagship
    JSON sets ``scan_layers``) both load into the port's unrolled DiT."""
    n, t = 1, 2
    args = (_rand(n * t, 8, 8, 8, seed=14),
            np.array([1000.0, 1000.0], np.float32))
    motion = dict(camera_motion_target=_rand(n, t, 16, 6, seed=15),
                  object_motion_source=_rand(n * t, 3, 10, seed=16),
                  object_motion_target=_rand(n * t, 3, 10, seed=17))
    jmod = jdit.VelocityDiTImgSpatialTempMotion(scan_layers=scan, **DIT_KW)
    jargs = [jnp.asarray(a) for a in args]
    jm = {k: jnp.asarray(v) for k, v in motion.items()}
    params = _perturb(jax.device_get(jax.jit(jmod.init)(KEY, *jargs, **jm)))
    if scan:
        assert "layers" in params["params"]
    want = jax.jit(jmod.apply)(params, *jargs, **jm)
    tmod = _port(params, tdit.VelocityDiTImgSpatialTempMotion(**DIT_KW))
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, args),
                   **{k: torch.from_numpy(v) for k, v in motion.items()})
    _close(got, want)


@pytest.fixture(scope="module")
def tiny_amd():
    jmod = graft._flagship(tiny=True, frames=4)
    jmod = jamd.AMDModelNew(cfg=jmod.cfg.replace(scan_layers=True))
    v = jnp.zeros((1, 4, 4, 16, 16))
    params = jax.device_get(jax.jit(jmod.init)({"params": KEY, "noise": KEY},
                                               v, v, v, v))
    params = _perturb(params)
    tmod = tamd.AMDModelNew(tamd.AMDConfig.from_dict(jmod.cfg.to_dict()),
                            device="cpu")
    return jmod, params, _port(params, tmod)


def test_amd_encode_and_velocity(tiny_amd):
    jmod, params, tmod = tiny_amd
    video, ref = _rand(1, 4, 4, 16, 16, seed=18), _rand(1, 4, 4, 16, 16,
                                                         seed=19)
    grey, rgrey = _rand(1, 4, 4, 16, 16, seed=20), _rand(1, 4, 4, 16, 16,
                                                         seed=21)
    jin = [jnp.asarray(a) for a in (video, ref, grey, rgrey)]
    want = jax.jit(lambda p, *a: jmod.apply(p, *a, method="encode"))(
        params, *jin)
    with torch.no_grad():
        got = tmod.encode(*map(torch.from_numpy, (video, ref, grey, rgrey)))
    _close(got, want)

    img = _rand(4, 8, 16, 16, seed=22)
    steps = np.full((4,), 700.0, np.float32)
    jv = jax.jit(lambda p, *a: jmod.apply(p, *a, method="velocity"))(
        params, jnp.asarray(img), jnp.asarray(steps), *want)
    with torch.no_grad():
        tv = tmod.velocity(torch.from_numpy(img), torch.from_numpy(steps),
                           *got)
    _close(tv, jv)


def test_amd_config_roundtrip_and_flagship_json():
    import json
    with open("configs/amd/amd_n_t1d512_spatial.json") as f:
        d = json.load(f)
    assert tamd.AMDConfig.from_dict(d).to_dict() == \
        jamd.AMDConfig.from_dict(d).to_dict()


def test_amd_n_factory_matches_jax():
    """Full-width AMD_N, built on the meta device (no memory): the same
    config as the JAX factory, and the flagship's 696 M parameters."""
    kw = dict(use_filter=True, use_grey=True, camera_motion_token_num=16,
              camera_motion_token_channel=16, object_motion_token_num=4,
              object_motion_token_channel=512,
              diffusion_model_type="spatial")
    model = tamd.AMD_N(device="meta", **kw)
    assert model.cfg.to_dict() == jamd.AMD_N(**kw).cfg.to_dict()
    n = sum(p.numel() for p in model.parameters())
    assert 695e6 < n < 697e6


def test_amd_rejects_unported_options():
    """``AMDModelNew`` builds the ``default`` and ``spatial`` DiTs, as the
    JAX package's does; any other type is refused, as there."""
    with pytest.raises(ValueError, match="diffusion_model_type"):
        tamd.AMDModelNew(tamd.AMDConfig(diffusion_model_type="dual"),
                         device="cpu")


TINY_VAE = dict(block_out_channels=(32, 64), layers_per_block=1,
                norm_num_groups=8)


@pytest.fixture(scope="module")
def tiny_vae():
    jmod = jvae.AutoencoderKL(cfg=jvae.VAEConfig(**TINY_VAE))
    params = _perturb(jax.device_get(jax.jit(jmod.init)(
        KEY, jnp.zeros((1, 3, 16, 16)))))
    tmod = tvae.AutoencoderKL(tvae.VAEConfig(**TINY_VAE), device="cpu")
    return jmod, params, _port(params, tmod)


def test_vae_encode_decode(tiny_vae):
    jmod, params, tmod = tiny_vae
    pixels = np.clip(_rand(1, 3, 3, 16, 16, seed=23, scale=0.5), -1, 1)
    jz = jvae.vae_encode(jmod, params, jnp.asarray(pixels))
    tz = tvae.vae_encode(tmod, torch.from_numpy(pixels))
    _close(tz, jz)
    lat = _rand(1, 3, 4, 8, 8, seed=24, scale=0.2)
    _close(tvae.vae_decode(tmod, torch.from_numpy(lat)),
           jvae.vae_decode(jmod, params, jnp.asarray(lat)))
    rgb = tvae.vae_decode_rgb(tmod, torch.from_numpy(lat))
    want = np.asarray(jvae.vae_decode_rgb(jmod, params, jnp.asarray(lat)))
    assert rgb.dtype == torch.uint8 and rgb.shape == want.shape
    assert np.abs(rgb.numpy().astype(int) - want.astype(int)).max() <= 1
