"""The other models of the port against the JAX package, fp32 on the CPU,
and the attention routes of this slice's full-width models:

  * ``DownEncoder``, ``Upsampler`` and ``MapConv``
    (``models/conv_blocks.py``) and ``CNNMotionAE`` with its loss
    (``models/model_ae.py``) at narrow widths: within 1e-4 relative to the
    output's largest element (fp32 convolutions summed in another order);
  * ``models/base.py``: ``get_sample_t_schedule`` bit for bit,
    ``sample_t``/``sample_timestep`` and ``RectifiedFlowHarness.forward``
    and ``sample`` (uniform steps and a ``t_schedule``) with the JAX draws
    replayed (1e-6);
  * every discriminator of ``losses/discriminator.py``, ``train=False``
    and ``train=True`` twice (the output of each call within 1e-5 of the
    JAX module's with a mutable ``batch_stats``, and the running mean and
    variance after the two calls within 1e-6: flax's momentum 0.99 and
    biased batch variance), its JAX ``batch_stats`` through the bridge
    with no missing or unexpected key; the four GAN helpers (1e-6);
  * on ``meta`` tensors, which stand in for the card: which attentions of
    the full-width T2M head (at the default token counts, with an object
    source, and at AMD_N's 4 object tokens), MAE_S and MAE_L (training
    and ``reconstruct``), the CNN motion AE at 32 x 32 latents and the
    discriminators reach which kernel, counted call by call, and the
    full-block launch plans of the new shapes (D 128 at S 269-298, D 32
    and 64 at S 257) within a block's 232,448 bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivae_tpu.losses import discriminator as jdisc
from hivae_tpu.models import base as jbase
from hivae_tpu.models import conv_blocks as jconv
from hivae_tpu.models import model_ae as jae
from hivae_tpu_torch.losses import discriminator as tdisc
from hivae_tpu_torch.models import base as tbase
from hivae_tpu_torch.models import conv_blocks as tconv
from hivae_tpu_torch.models import mae as tmae
from hivae_tpu_torch.models import model_ae as tae
from hivae_tpu_torch.models import t2m as tt2m
from hivae_tpu_torch.ops import attention as tattn
from hivae_tpu_torch.ops.kernels import flash_attention as tfa
from hivae_tpu_torch.utils.params import flax_to_torch
from test_torch_amd_family import _one_thread  # noqa: F401
from test_torch_amd_family_models import random_params
from test_torch_training import _close_rel, _replay

KEY = jax.random.PRNGKey(0)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(params, module):
    module.load_state_dict(flax_to_torch(params), strict=True)
    return module


# -- conv blocks and the CNN motion AE ----------------------------------------

CONV_CASES = {
    "DownEncoder": (
        lambda: jconv.DownEncoder(block_out_channels=(8, 16), norm_groups=4,
                                  resnet_layers_per_block=1),
        lambda: tconv.DownEncoder(6, (8, 16), 4, 1), (2, 6, 8, 8)),
    "DownEncoder conv_in 1, no attention": (
        lambda: jconv.DownEncoder(block_out_channels=(8, 16, 16),
                                  norm_groups=4, conv_in_kernel=1,
                                  add_attention=False),
        lambda: tconv.DownEncoder(3, (8, 16, 16), 4, add_attention=False,
                                  conv_in_kernel=1), (1, 3, 8, 8)),
    "Upsampler": (
        lambda: jconv.Upsampler(block_out_channels=(16, 8), out_channel=3,
                                norm_groups=4, resnet_layers_per_block=1),
        lambda: tconv.Upsampler(16, (16, 8), 3, 4, 1), (2, 16, 4, 4)),
    "Upsampler, no conv_final": (
        lambda: jconv.Upsampler(block_out_channels=(8, 8), norm_groups=4,
                                resnet_layers_per_block=1),
        lambda: tconv.Upsampler(8, (8, 8), None, 4, 1), (1, 8, 4, 4)),
    "MapConv": (
        lambda: jconv.MapConv(hidden=16, out_channel=4, block_layer=2),
        lambda: tconv.MapConv(8, 16, 4, 2), (2, 8, 6, 6)),
}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv_blocks_match_jax(name):
    jfn, tfn, shape = CONV_CASES[name]
    jmod, x = jfn(), _rand(*shape, seed=1)
    params = random_params(jmod, x, seed=2)
    tmod = _port(params, tfn())
    want = np.asarray(jax.jit(jmod.apply)(params, x))
    got = tmod(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    _close_rel(got, want, tol=1e-4)


def test_cnn_motion_ae_and_loss_match_jax():
    jmod = jae.CNNMotionAE(block_out_channels_down=(8, 16, 16, 16))
    video = _rand(1, 3, 4, 8, 8, seed=3)
    params = random_params(jmod, video, seed=4)
    tmod = _port(params, tae.CNNMotionAE(
        block_out_channels_down=(8, 16, 16, 16), device="cpu"))
    gt = _rand(1, 3, 4, 8, 8, seed=5)
    want, want_loss = jax.jit(lambda p: (
        lambda pred: (pred, jmod.apply(p, pred, gt, method="loss")))(
            jmod.apply(p, video)))(params)
    got = tmod(torch.from_numpy(video))
    assert got.shape == video.shape
    _close_rel(got.detach().numpy(), np.asarray(want), tol=1e-4)
    loss = tmod.loss(got, torch.from_numpy(gt))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    # the loss skips frame 0
    assert tmod.loss(torch.zeros(1, 2, 1), torch.tensor(
        [[[5.0], [0.0]]])).item() == 0.0


# -- the rectified-flow harness ------------------------------------------------


@pytest.mark.parametrize("steps,sched", [(10, None), (4, {"m": 2, "n": 50}),
                                         (7, {})])
def test_sample_t_schedule_bit_equal(steps, sched):
    want = jbase.get_sample_t_schedule(sched, steps)
    got = tbase.get_sample_t_schedule(sched, steps)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_timestep_samplers_match_jax():
    normal = _rand(64, seed=6)
    with _replay(normal=[normal, normal]):
        jt = np.asarray(jbase.sample_t(KEY, 64, 0.3, 1.2))
        jts = np.asarray(jbase.sample_timestep(KEY, 64, 0.3, 1.2, 1000))
    tt = tbase.sample_t(64, 0.3, 1.2, normal=torch.from_numpy(normal))
    tts = tbase.sample_timestep(64, 0.3, 1.2, 1000,
                                normal=torch.from_numpy(normal))
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-6)
    assert tts.dtype == torch.int32
    assert np.abs(tts.numpy() - jts).max() <= 1   # truncation at a boundary
    assert np.mean(tts.numpy() == jts) >= 0.95


def _velocity(lib):
    """A conditioned velocity that reads the timestep: c - z scaled by
    (1 + t / 1000)."""
    def fn(z, c, t):
        shape = (-1,) + (1,) * (z.ndim - 1)
        return (c - z) * (1.0 + t.reshape(shape) / 1000.0)
    return fn


def test_harness_forward_matches_jax():
    gt, cond = _rand(3, 4, 5, seed=7), _rand(3, 4, 5, seed=8)
    ts, noise = np.array([0, 371, 1000], np.int32), _rand(3, 4, 5, seed=9)
    with _replay(randint=[ts], normal=[noise]):
        want = jbase.RectifiedFlowHarness(_velocity(jnp)).forward(
            KEY, jnp.asarray(gt), jnp.asarray(cond))
    got = tbase.RectifiedFlowHarness(_velocity(torch)).forward(
        torch.from_numpy(gt), torch.from_numpy(cond),
        timestep=torch.from_numpy(ts), noise=torch.from_numpy(noise))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_array_equal(got[0][0].numpy(), gt[0])   # t = 1


@pytest.mark.parametrize("sched", [None, {"m": 1, "n": 100}])
def test_harness_sample_matches_jax(sched):
    cond, z0 = _rand(2, 6, seed=10), _rand(2, 6, seed=11)
    with _replay(normal=[z0]):
        want = jbase.RectifiedFlowHarness(_velocity(jnp)).sample(
            KEY, (2, 6), jnp.asarray(cond), sample_steps=5, t_schedule=sched)
    got = tbase.RectifiedFlowHarness(_velocity(torch)).sample(
        (2, 6), torch.from_numpy(cond), sample_steps=5, t_schedule=sched,
        z0=torch.from_numpy(z0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# -- the discriminators ---------------------------------------------------------

DISC_CASES = {
    "NLayerDiscriminator": (dict(ndf=8), (2, 3, 32, 32), False),
    "NLayerDiscriminator3D": (dict(ndf=4), (2, 3, 32, 32, 32), False),
    "Discriminator3DConv": (dict(ndf=4, mlp_hidden_dim=16),
                            (2, 4, 8, 16, 16), False),
    "Discriminator2DConv": (dict(ndf=4, mlp_hidden_dim=16, use_sigmoid=True),
                            (2, 4, 16, 16), False),
    "Discriminator2DConvVel": (dict(ndf=4, mlp_hidden_dim=16,
                                    time_embed_dim=16), (2, 8, 16, 16), True),
}


def _variables(shapes, seed):
    """Random params; running variances positive."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        x = rng.randn(*leaf.shape).astype(np.float32)
        return np.abs(x) + 0.5 if str(path[-1].key) == "var" else 0.2 * x
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("name", sorted(DISC_CASES))
def test_discriminators_match_jax(name):
    kw, shape, timed = DISC_CASES[name]
    jmod = getattr(jdisc, name)(**kw)
    x = _rand(*shape, seed=12)
    args = (x, np.array([10.0, 500.0], np.float32)) if timed else (x,)
    variables = _variables(jax.eval_shape(
        lambda: jmod.init(KEY, *args)), seed=13)
    assert set(variables) == {"params", "batch_stats"}
    tmod = _port(variables, getattr(tdisc, name)(
        in_channels=shape[1], device="cpu", **kw))
    targs = [torch.from_numpy(a) for a in args]
    want = np.asarray(jax.jit(lambda v: jmod.apply(v, *args))(variables))
    got = tmod(*targs).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    step = jax.jit(lambda v: jmod.apply(v, *args, train=True,
                                        mutable=["batch_stats"]))
    stats = variables
    for _ in range(2):
        want, upd = step(stats)
        stats = {"params": variables["params"], **upd}
        got = tmod(*targs, train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    ref = flax_to_torch(stats)
    buffers = dict(tmod.named_buffers())
    assert {k for k in ref if "running" in k} == set(buffers)
    for k, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), ref[k].numpy(), atol=1e-6)
    # the train-mode output has the expected shape
    assert got.shape == want.shape


def test_discriminator_attn_matches_jax():
    kw = dict(latent_width=8, latent_height=8, head_dim=8, heads=2,
              num_layers=2, mlp_hidden_dim=16)
    jmod = jdisc.Discriminator2DAttn(**kw)
    x, ts = _rand(2, 8, 8, 8, seed=14), np.array([3.0, 700.0], np.float32)
    params = random_params(jmod, x, ts, seed=15)
    tmod = _port(params, tdisc.Discriminator2DAttn(device="cpu", **kw))
    want = np.asarray(jax.jit(jmod.apply)(params, x, ts))
    got = tmod(torch.from_numpy(x), torch.from_numpy(ts)).detach().numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_gan_helpers_match_jax():
    real, fake = _rand(4, 5, seed=16), _rand(4, 5, seed=17)
    tr, tf = torch.from_numpy(real), torch.from_numpy(fake)
    for name in ("hinge_d_loss", "vanilla_d_loss"):
        np.testing.assert_allclose(
            getattr(tdisc, name)(tr, tf).item(),
            float(getattr(jdisc, name)(real, fake)), rtol=1e-6)
    np.testing.assert_allclose(tdisc.generator_loss(tf).item(),
                               float(jdisc.generator_loss(fake)), rtol=1e-6)
    for nll, g in ((3.0, 0.5), (1e6, 1e-3), (0.0, 2.0)):
        np.testing.assert_allclose(
            tdisc.adaptive_gan_weight(torch.tensor(nll),
                                      torch.tensor(g)).item(),
            float(jdisc.adaptive_gan_weight(jnp.float32(nll),
                                            jnp.float32(g))), rtol=1e-6)


# -- the routes of the slice's full-width models (meta stands in for the card)


@pytest.fixture
def routes(monkeypatch):
    """Every ``sdpa`` call of a run on ``meta``: (route, q shape); the
    kernels' wrappers replaced by stand-ins that return empty outputs."""
    calls = []

    def full_block(q, k, v, *, scale, bias=None):
        calls.append(("full_block", tuple(q.shape)))
        return torch.empty_like(q)

    def stream(q, k, v, *, scale, bias=None, full_block=False):
        calls.append(("stream", tuple(q.shape)))
        return torch.empty_like(q), torch.empty(q.shape[:3] + (1,),
                                                device=q.device)
    monkeypatch.setattr(tfa, "full_block_attention", full_block)
    monkeypatch.setattr(tfa, "stream_attention", stream)
    plain = tattn._sdpa_plain

    def counted(q, k, v, scale, key_mask):
        shape = tuple(q.shape)
        out = plain(q, k, v, scale, key_mask)
        kind = tattn._kernel_kind(q.shape, k.shape)
        calls.append(("sdpa_plain" if kind else "plain", shape))
        return out
    monkeypatch.setattr(tattn, "_sdpa_plain", counted)
    return calls


def _tally(calls):
    out = {}
    for route, shape in calls:
        out[(route, shape)] = out.get((route, shape), 0) + 1
    return out


@pytest.mark.parametrize("case,tokens", [
    ("default counts", 16 + 1 + 8), ("object source", 2 * 16 + 2 + 8),
    ("AMD_N's 4 object tokens", 4 + 1 + 8)])
def test_t2m_routes_at_full_width(routes, case, tokens):
    """The default head (2048 wide, 16 x 128, 20 layers) in bf16, N 1 of
    16 frames: 20 joint blocks at 16 rows of ``tokens`` + 256 patches on
    the full-block kernel at D 128, the 20 motion blocks plain."""
    over = {"object_token_num": 4} if "AMD_N" in case else {}
    cfg = tt2m.T2MConfig(**over)
    model = tt2m.Label2MotionDiffusionDecoder(cfg, device="meta",
                                              dtype=torch.bfloat16)
    n, t = 1, 16
    otn = cfg.object_token_num
    with torch.no_grad():
        model(torch.empty(n, t, 8, 8, device="meta"),
              torch.empty(n * t, otn, 32, device="meta"),
              torch.zeros(n, dtype=torch.long, device="meta"),
              torch.empty(n, t, 4, 32, 32, device="meta"),
              torch.empty(n, device="meta"),
              object_source_motion=(torch.empty(n * t, otn, 32,
                                                device="meta")
                                    if case == "object source" else None),
              noise=torch.empty(n * t, otn, 32, device="meta"))
    assert _tally(routes) == {
        ("full_block", (16, 16, tokens + 256, 128)): 20,
        ("plain", (16, 16, tokens, 128)): 20}


@pytest.mark.parametrize("name,heads", [("MAE_S", 12), ("MAE_L", 16)])
def test_mae_routes_at_full_width(routes, name, heads):
    """Training at mask 0.75: the encoder's 65 tokens plain, the decoder's
    8 blocks at 257 tokens on the full-block kernel at D 32;
    ``reconstruct``: the encoder at 257 tokens at D 64 too."""
    model = tmae.MAE_MODELS[name](device="meta")
    depth = len(model.transformer_blocks)
    imgs = torch.empty(32, 4, 32, 32, device="meta")
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                         enabled=False):
        model.to(torch.bfloat16)(imgs.bfloat16(), 0.75,
                                 noise=torch.empty(32, 256, device="meta"))
        assert _tally(routes) == {
            ("plain", (32, heads, 65, 1024 // heads if name == "MAE_L"
                       else 768 // heads)): depth,
            ("full_block", (32, 16, 257, 32)): 8}
        routes.clear()
        model.reconstruct(imgs[:1].bfloat16())
    assert _tally(routes) == {
        ("full_block", (1, heads, 257, 64)): depth,
        ("full_block", (1, 16, 257, 32)): 8}


def test_other_models_routes(routes):
    """The CNN motion AE at 32 x 32 latents: its DownEncoder's and
    Upsampler's mid-block attentions over the 4 x 4 grid plain, MapConv's
    over 32 x 32 at 640 channels on the streaming kernel (as JAX's
    ``auto`` sends it to ``_stream_fwd_kernel``), no ``sdpa_plain``;
    ``Discriminator2DAttn`` at its defaults (256 patches: 256^2 logits)
    plain."""
    ae = tae.CNNMotionAE(device="meta", dtype=torch.bfloat16)
    with torch.no_grad():
        ae(torch.empty(1, 2, 4, 32, 32, device="meta",
                       dtype=torch.bfloat16))
    assert _tally(routes) == {("plain", (2, 1, 16, 256)): 2,
                              ("stream", (2, 1, 1024, 640)): 1}
    routes.clear()
    disc = tdisc.Discriminator2DAttn(device="meta", dtype=torch.bfloat16)
    with torch.no_grad():
        disc(torch.empty(2, 8, 32, 32, device="meta", dtype=torch.bfloat16),
             torch.empty(2, device="meta"))
    assert _tally(routes) == {("plain", (2, 12, 256, 64)): 8}


@pytest.mark.parametrize("s,d", [(269, 128), (281, 128), (298, 128),
                                 (257, 32), (257, 64)])
def test_new_full_block_plans_fit(s, d):
    """The slice's new full-block shapes are admitted, and the forward's
    and the backward's plans fit a block's 232,448 bytes."""
    assert tattn.full_block_fits((1, 16, s, d), (1, 16, s, d))
    plan = tfa._full_block_plan(s, s, d)
    assert plan.fwd_smem <= tfa.SMEM_PER_BLOCK == 232_448
    assert plan.bwd_smem <= tfa.SMEM_PER_BLOCK
    if plan.resident:
        assert plan.fwd_smem <= tfa.SMEM_TWO_PER_SM
