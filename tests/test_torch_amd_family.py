"""The modules the port's dual-encoder AMD family runs
(``ops/regularizers.py``, ``MotionTemporalBlock``,
``MotionEncoderSpatialTemporal``, ``VelocityDiT``,
``VelocityDiTImgSpatial``, ``VelocityDiTDualStream``,
``ReconstructionDiT`` in both forms) against the JAX package's, fp32 on
the CPU (the models themselves:
``test_torch_amd_family_models.py``; serving and training them:
``test_torch_amd_family_serving.py``). ``TINY`` is the widths of
``tests/test_amd.py`` with one encoder layer.

The flax parameters (perturbed, so that no mis-mapped leaf hides behind
its init value) load into the port with ``strict=True``; mask draws are
recorded from the JAX side and given to the port. Outputs within 2e-4
absolute and relative (``test_torch_models.TOL``).

A config whose camera and object token counts differ is refused with a
``ValueError`` naming both, where the JAX package fails on a broadcast.
The factories' parameter counts: ``test_torch_amd_family_factories.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivae_tpu.models import amd as jamd
from hivae_tpu.models import blocks as jblocks
from hivae_tpu.models import dit as jdit
from hivae_tpu.models import motion_encoders as jenc
from hivae_tpu.ops import regularizers as jreg
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import blocks as tblocks
from hivae_tpu_torch.models import dit as tdit
from hivae_tpu_torch.models import motion_encoders as tenc
from hivae_tpu_torch.ops import regularizers as treg
from test_torch_models import KEY, _close, _perturb, _port, _rand

N, T, LAT = 2, 4, 16
TINY = dict(image_height=LAT, image_width=LAT, video_frames=T,
            object_motion_token_num=4, object_motion_token_channel=32,
            object_enc_num_layers=1, enc_nhead=2, enc_ndim=16,
            camera_motion_token_num=4, camera_motion_token_channel=16,
            camera_enc_num_layers=1, motion_token_num=4,
            motion_token_channel=32, diffusion_attn_head_dim=16,
            diffusion_attn_num_heads=4, diffusion_num_layers=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def mask_draws(monkeypatch):
    """The uniforms the JAX package's token masks draw (from keys that
    flax derives per module), recorded in call order; run eagerly."""
    drawn = []

    def wrap(fn):
        def recorded(key, x, mask_ratio, axis=1):
            drawn.append(np.asarray(jax.random.uniform(
                key, (x.shape[0], x.shape[axis]))))
            return fn(key, x, mask_ratio, axis)
        return recorded
    for name in ("random_mask_tokens", "shuffle_mask_tokens"):
        monkeypatch.setattr(jenc, name, wrap(getattr(jenc, name)))
    return drawn


# -- ops/regularizers.py -------------------------------------------------------


def test_diagonal_gaussian_matches_jax():
    params = _rand(6, 8, 5, seed=1, scale=3.0)   # logvar past the clamp too
    noise = _rand(6, 4, 5, seed=2)
    jpost = jreg.DiagonalGaussian.from_params(jnp.asarray(params))
    tpost = treg.DiagonalGaussian.from_params(_t(params))
    for name in ("mean", "logvar", "std", "var"):
        _close(getattr(tpost, name), getattr(jpost, name))
    _close(tpost.kl(), jpost.kl())
    _close(tpost.kl((1,)), jpost.kl((1,)))
    sample = _rand(6, 4, 5, seed=3)
    _close(tpost.nll(_t(sample)), jpost.nll(jnp.asarray(sample)))

    key = jax.random.PRNGKey(5)
    jz, jkl = jreg.diagonal_gaussian_regularize(jnp.asarray(params), key)
    drawn = np.asarray(jax.random.normal(key, (6, 4, 5)))
    tz, tkl = treg.diagonal_gaussian_regularize(_t(params), noise=_t(drawn))
    _close(tz, jz)
    np.testing.assert_allclose(tkl.item(), float(jkl), rtol=2e-6)
    jmode, _ = jreg.diagonal_gaussian_regularize(jnp.asarray(params),
                                                 sample=False)
    _close(treg.diagonal_gaussian_regularize(_t(params), sample=False)[0],
           jmode)
    # the noise is what the sample reads
    tz2, _ = treg.diagonal_gaussian_regularize(_t(params), noise=_t(noise))
    assert not torch.allclose(tz, tz2)


# -- blocks and encoders -------------------------------------------------------

DIM, HEADS, HD, COND = 32, 2, 16, 24


@pytest.mark.parametrize("use_adaln", [False, True])
def test_motion_temporal_block_matches_jax(use_adaln):
    x = _rand(3, 6, DIM, seed=1)
    temb = _rand(3, COND, seed=2)
    jmod = jblocks.MotionTemporalBlock(DIM, HEADS, HD, use_adaln=use_adaln)
    args = (x, temb) if use_adaln else (x,)
    params = _perturb(jax.device_get(jmod.init(
        KEY, *map(jnp.asarray, args))))
    want = jmod.apply(params, *map(jnp.asarray, args))
    tmod = _port(params, tblocks.MotionTemporalBlock(
        DIM, HEADS, HD, use_adaln=use_adaln,
        cond_dim=COND if use_adaln else None))
    with torch.no_grad():
        _close(tmod(*map(_t, args)), want)


ENC = dict(img_height=8, img_width=8, img_inchannel=4, img_patch_size=2,
           motion_token_num=3, motion_channel=12, video_frames=4, heads=2,
           head_dim=16, num_layers=2)


@pytest.mark.parametrize("mask", [None, "static", "jitter"])
@pytest.mark.parametrize("norm_out", [False, True])
def test_spatial_temporal_encoder_matches_jax(mask, norm_out, mask_draws):
    """Unmasked; a float ratio (tokens dropped; the uniform the JAX
    package draws from its key given to the port); a traced ratio (tokens
    shuffled and hidden as keys; the argsort of the same uniform as the
    port's permutation)."""
    video = _rand(2, 2 * 3, 4, 8, 8, seed=4)   # cat(3 refs, 3 targets)
    jmod = jenc.MotionEncoderSpatialTemporal(need_norm_out=norm_out, **ENC)
    tmod = tenc.MotionEncoderSpatialTemporal(need_norm_out=norm_out, **ENC)
    params = _perturb(jax.device_get(jmod.init(KEY, jnp.asarray(video))))
    _port(params, tmod)
    ratio = {None: None, "static": 0.5, "jitter": 0.4}[mask]
    jratio = jnp.float32(ratio) if mask == "jitter" else ratio
    want = jmod.apply(params, jnp.asarray(video), jratio,
                      rngs={"mask": jax.random.PRNGKey(9)})
    kw = {}
    if mask == "static":
        kw = dict(u=_t(mask_draws[0]))
    elif mask == "jitter":
        kw = dict(perm=torch.argsort(_t(mask_draws[0]), dim=1, stable=True))
    assert len(mask_draws) == (mask is not None)
    tratio = torch.tensor(ratio) if mask == "jitter" else ratio
    with torch.no_grad():
        got = tmod(_t(video), tratio, **kw)
    _close(got, want)


# -- the DiTs ------------------------------------------------------------------

DIT = dict(heads=2, head_dim=16, out_channels=4, image_height=8,
           image_width=8, image_patch_size=2, image_in_channels=8,
           motion_in_channels=12)
L = 3


def _dit_inputs(frames=2, clips=2):
    nt = frames * clips
    img = _rand(nt, 8, 8, 8, seed=11)
    ts = np.random.RandomState(12).randint(0, 1001, nt).astype(np.float32)
    streams = [_rand(nt, L, 12, seed=13 + i) for i in range(4)]
    return img, ts, streams


def _dit_pair(jmod, tmod, args, kwargs):
    params = _perturb(jax.device_get(jmod.init(
        KEY, *[None if a is None else jnp.asarray(a) for a in args],
        **{k: None if v is None else jnp.asarray(v)
           for k, v in kwargs.items()})))
    want = jmod.apply(params, *[None if a is None else jnp.asarray(a)
                                for a in args],
                      **{k: None if v is None else jnp.asarray(v)
                         for k, v in kwargs.items()})
    _port(params, tmod)
    with torch.no_grad():
        got = tmod(*[None if a is None else _t(a) for a in args],
                   **{k: None if v is None else _t(v)
                      for k, v in kwargs.items()})
    _close(got, want)


# (motion_type, camera source given, object stream given)
STREAM_CASES = [("plus", True, True), ("plus", True, False),
                ("decouple", True, True), ("decouple", False, True),
                ("decouple", True, False)]


@pytest.mark.parametrize("motion_type,cam_src,obj", STREAM_CASES)
def test_velocity_dit_matches_jax(motion_type, cam_src, obj):
    """Three layers with the camera stream on [0, 2) and the object stream
    on [1, 3): the overlapping ranges of ``decouple``."""
    img, ts, (cs, ct, os_, ot) = _dit_inputs()
    kw = dict(DIT, num_layers=3, motion_type=motion_type, camera_layers=2,
              object_from=1)
    jmod = jdit.VelocityDiT(**kw)
    tmod = tdit.VelocityDiT(**kw)
    _dit_pair(jmod, tmod, (ct, img, ts),
              dict(camera_motion_source=cs if cam_src else None,
                   object_motion_source=os_ if obj else None,
                   object_motion_target=ot if obj else None))


@pytest.mark.parametrize("motion_type,cam_src,obj",
                         [("plus", True, True)] + STREAM_CASES[2:])
def test_velocity_dit_img_spatial_matches_jax(motion_type, cam_src, obj):
    """Three layers, the camera stream on [0, 2) and the object stream on
    [2, 3) (flax names a layer once, so the JAX module runs no layer
    twice)."""
    img, ts, (cs, ct, os_, ot) = _dit_inputs()
    kw = dict(DIT, num_layers=3, motion_type=motion_type,
              motion_target_num_frame=2, camera_until=2, object_from=2)
    jmod = jdit.VelocityDiTImgSpatial(**kw)
    tmod = tdit.VelocityDiTImgSpatial(**kw)
    _dit_pair(jmod, tmod, (ct, img, ts),
              dict(camera_motion_source=cs if cam_src else None,
                   object_motion_source=os_ if obj else None,
                   object_motion_target=ot if obj else None))


def test_velocity_dit_dual_stream_matches_jax():
    img, ts, (ms, mt, _, _) = _dit_inputs()
    ts = np.repeat(ts[::2], 2)          # one timestep a clip
    kw = dict(DIT, num_layers=2, motion_target_num_frame=2)
    _dit_pair(jdit.VelocityDiTDualStream(**kw),
              tdit.VelocityDiTDualStream(**kw), (ms, mt, img, ts), {})


@pytest.mark.parametrize("split", [False, True])
def test_reconstruction_dit_matches_jax(split):
    img, _, (ms, mt, _, _) = _dit_inputs()
    kw = dict(DIT, num_layers=2)
    jcls = jdit.ReconstructionDiTSplit if split else jdit.ReconstructionDiT
    _dit_pair(jcls(**kw), tdit.ReconstructionDiT(split=split, **kw),
              (ms, mt, img), {})


def test_unknown_dit_type_raises():
    with pytest.raises(ValueError, match="diffusion_model_type"):
        tamd.AMDModel(tamd.AMDConfig(**TINY, diffusion_model_type="split"),
                      device="cpu")


@pytest.mark.parametrize("dit", ["spatial", "default", "dual"])
def test_unequal_token_counts_raise_where_jax_fails(dit):
    """The JAX package fails in its first forward (a broadcast of the
    object tokens against the camera tokens' positions, or of the two
    streams' sum); the port raises a ValueError naming both counts."""
    over = dict(TINY, object_motion_token_num=2, camera_motion_token_num=4,
                use_filter=True, diffusion_model_type=dit)
    jmod = jamd.AMDModel(cfg=jamd.AMDConfig(**over))
    v = jnp.zeros((1, T, 4, LAT, LAT))
    with pytest.raises((TypeError, ValueError), match="broadcast|shapes"):
        jax.eval_shape(lambda: jmod.init({"params": KEY, "noise": KEY}, v,
                                         v))
    tmod = tamd.AMDModel(tamd.AMDConfig(**over), device="cpu")
    z = torch.zeros(1, T, 4, LAT, LAT)
    with pytest.raises(ValueError, match=r"camera stream has 4 .* object "
                                         r"stream 2"):
        tmod(z, z)
