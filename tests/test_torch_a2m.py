"""The port's A2M head (``models/a2m.py`` and its blocks in
``models/blocks.py``) against the JAX package's (``hivae_tpu/models/a2m.py``),
fp32 on the CPU at tiny widths:

  * ``A2MMotionSelfAttnBlock``, ``A2MCrossAttnBlock`` (condition windows
    batched per frame or not) and ``AudioFeatureWindowMlp``;
  * ``A2MTransformerCrossAttnAudio`` with audio, pose and both;
  * ``A2MModelCrossAttnAudio``'s ``conditions``, ``velocity`` and training
    loss (the per-frame mask-weighted velocity MSE) with the timestep
    injected on both sides and the JAX side's flow noise replayed;
  * ``sample`` with the Euler and the Heun solver, the JAX draws recorded
    as they are made (``test_torch_serving.recorded_draws``) and replayed
    through ``SampleDraws``;
  * the bridge: every JAX leaf maps onto a port parameter of its shape;
  * the token-count ``ValueError`` where the JAX head fails on a broadcast;
  * on ``meta``: the flagship yaml's parameter count against
    ``jax.eval_shape`` (361.2 M, with ``motion_num_token`` 1 and 4) and
    its int8 ``a2m`` table selection against the JAX package's.

Parameters come from ``jax.eval_shape`` of the flax init filled from a
numpy seed (``test_torch_amd_family_models.random_params``: no flax init
compile) and load into the port with ``strict=True``. Outputs within
``test_torch_models.TOL`` (2e-4); samples within ``test_torch_serving.TOL``
(1e-3: each ODE step carries the difference on); losses within 2e-4
relative."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_serving as common
from hivae_tpu.models import a2m as ja2m
from hivae_tpu.models import blocks as jblocks
from hivae_tpu.ops import quant as jq
from hivae_tpu_torch.models import a2m as ta2m
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import blocks as tblocks
from hivae_tpu_torch.ops import quant as tq
from hivae_tpu_torch.pipelines import pipeline as tpipe
from hivae_tpu_torch.utils.params import flax_path_to_torch_key, flax_to_torch
from test_torch_amd_family import _one_thread  # noqa: F401
from test_torch_amd_family_models import random_params
from test_torch_models import _close

N, F_, L, D = 2, 4, 2, 16
M, C = 3, 8
POSE = 8
# the tiny head: whisper-like features (M, C) a frame, L tokens of D
TINY = dict(audio_inchannel=C, audio_block=M, motion_num_token=L,
            motion_in_channel=D, motion_frames=F_, window_size=2,
            encoder_out_dim=16, intermediate_dim=24,
            diffusion_attn_head_dim=8, diffusion_attn_num_heads=2,
            diffusion_num_layers=2, pose_height=POSE, pose_width=POSE,
            pose_inchannel=4, pose_patch_size=2)
FLAGSHIP = "configs/a2m/cross_audio_t1d512_l16_dim1024.yaml"
_BUILT = {}


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed=0, n=N, f=F_, l=L):
    """(motion (N, F, L, D), ref motion, audio, ref audio, pose, ref
    pose)."""
    return (_rand(n, f, l, D, seed=seed), _rand(n, l, D, seed=seed + 1),
            _rand(n, f, M, C, seed=seed + 2), _rand(n, M, C, seed=seed + 3),
            _rand(n, f, 4, POSE, POSE, seed=seed + 4),
            _rand(n, 4, POSE, POSE, seed=seed + 5))


def _cond_kw(x):
    _, _, audio, ref_audio, pose, ref_pose = x
    return dict(audio=audio, ref_audio=ref_audio, pose=pose,
                ref_pose=ref_pose)


def head(variant):
    """(flax module, params, port module) of the tiny head, built once a
    module."""
    if variant not in _BUILT:
        jmod = ja2m.A2MModelCrossAttnAudio(cfg=ja2m.A2MConfig(**TINY),
                                           variant=variant)
        x = _inputs()
        params = random_params(jmod, jnp.asarray(x[0]), jnp.asarray(x[1]),
                               **{k: jnp.asarray(v)
                                  for k, v in _cond_kw(x).items()})
        tmod = ta2m.A2MModelCrossAttnAudio(ta2m.A2MConfig(**TINY), variant,
                                           device="cpu")
        tmod.load_state_dict(flax_to_torch(params), strict=True)
        _BUILT[variant] = (jmod, params, tmod.eval())
    return _BUILT[variant]


# -- the blocks ----------------------------------------------------------------

DIM, HEADS, HD, COND = 16, 2, 8, 12


def _block_pair(name):
    if name == "self_attn":
        return (jblocks.A2MMotionSelfAttnBlock(DIM, HEADS, HD),
                tblocks.A2MMotionSelfAttnBlock(DIM, HEADS, HD, COND))
    if name.startswith("cross"):
        return (jblocks.A2MCrossAttnBlock(DIM, HEADS, HD),
                tblocks.A2MCrossAttnBlock(DIM, HEADS, HD, COND))
    return (jblocks.AudioFeatureWindowMlp(intermediate_dim=24, window_size=3,
                                          outdim=DIM),
            tblocks.AudioFeatureWindowMlp(M * C, 24, 3, DIM))


@pytest.mark.parametrize("name", ["self_attn", "cross_4d", "cross_3d",
                                  "audio_window_mlp"])
def test_blocks_match_jax(name):
    jmod, tmod = _block_pair(name)
    motion, ref = _rand(N, F_ * L, DIM, seed=1), _rand(N, L, DIM, seed=2)
    temb = _rand(N, COND, seed=3)
    window = _rand(N, F_ + 1, 5, DIM, seed=4)
    args = {"self_attn": (motion, ref, temb),
            "cross_4d": (motion, ref, window, temb),
            "cross_3d": (motion, ref, window.reshape(-1, 5, DIM), temb),
            "audio_window_mlp": (_rand(N, F_, M, C, seed=5),)}[name]
    params = random_params(jmod, *map(jnp.asarray, args))
    want = jmod.apply(params, *map(jnp.asarray, args))
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        got = tmod.eval()(*map(_t, args))
    _close(got, want)


# -- the denoiser and the head -------------------------------------------------


@pytest.mark.parametrize("variant", ["audio", "pose", "audio_pose"])
def test_transformer_and_velocity_match_jax(variant):
    """``conditions`` (the audio windows encoded, the pose frames
    stacked), then the denoiser ``A2MTransformerCrossAttnAudio`` through
    ``velocity``."""
    jmod, params, tmod = head(variant)
    x = _inputs(seed=10)
    kw = _cond_kw(x)
    jcond = jmod.apply(params, method="conditions",
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        tcond = tmod.conditions(**{k: _t(v) for k, v in kw.items()})
    assert tcond.keys() == jcond.keys()
    for k in tcond:
        _close(tcond[k], jcond[k])
    ts = np.array([0.0, 613.0], np.float32)
    want = jmod.apply(params, jnp.asarray(x[0]), jnp.asarray(x[1]),
                      jnp.asarray(ts), method="velocity", **jcond)
    with torch.no_grad():
        got = tmod.velocity(_t(x[0]), _t(x[1]), _t(ts), **tcond)
    assert got.shape == (N, F_, L, D)
    _close(got, want)


@pytest.mark.parametrize("variant", ["audio", "pose", "audio_pose"])
def test_training_loss_matches_jax(monkeypatch, variant):
    """The masked velocity MSE at injected timesteps; the JAX flow noise
    recorded and given to the port as ``z0``."""
    jmod, params, tmod = head(variant)
    x = _inputs(seed=20)
    mask = np.array([[1, 0, 1, 1], [0, 1, 1, 0]], np.float32)
    ts = np.array([17, 980], np.int32)
    with common.recorded_draws(monkeypatch) as draws:
        want = jmod.apply(params, jnp.asarray(x[0]), jnp.asarray(x[1]),
                          mask=jnp.asarray(mask), timestep=jnp.asarray(ts),
                          rngs={"noise": jax.random.PRNGKey(5)},
                          **{k: jnp.asarray(v)
                             for k, v in _cond_kw(x).items()})
    assert len(draws) == 1 and draws[0].shape == x[0].shape
    got = tmod(_t(x[0]), _t(x[1]), mask=_t(mask), timestep=_t(ts).long(),
               z0=_t(draws[0]), **{k: _t(v) for k, v in _cond_kw(x).items()})
    for k in ("loss", "diff_loss"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=2e-4)


@pytest.mark.parametrize("solver", ["euler", "heun"])
def test_sample_matches_jax(monkeypatch, solver):
    jmod, params, tmod = head("audio")
    x = _inputs(seed=30)
    with common.recorded_draws(monkeypatch) as draws:
        want = ja2m.sample_jit(jmod, params, jax.random.PRNGKey(7),
                               jnp.asarray(x[1]), frames=F_, sample_step=3,
                               audio=jnp.asarray(x[2]),
                               ref_audio=jnp.asarray(x[3]), solver=solver)
    assert len(draws) == 1
    got = ta2m.sample(tmod, _t(x[1]), F_, sample_step=3, audio=_t(x[2]),
                      ref_audio=_t(x[3]), solver=solver,
                      generator=tamd.SampleDraws(replay=draws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **common.TOL)


# -- the bridge ----------------------------------------------------------------


@pytest.mark.parametrize("variant", ["audio", "pose", "audio_pose"])
def test_bridge_maps_every_jax_leaf(variant):
    _, params, tmod = head(variant)
    mapped = flax_to_torch(params)
    leaves = jax.tree_util.tree_leaves(params)
    assert len(mapped) == len(leaves)
    state = tmod.state_dict()
    assert mapped.keys() == state.keys()
    for k, v in mapped.items():
        assert tuple(v.shape) == tuple(state[k].shape), k


# -- the token count -----------------------------------------------------------


def test_token_count_refused_where_jax_fails():
    """L * (F + 1) positions past the table: the JAX head fails on a
    broadcast, the port raises a ValueError naming both counts. At
    exactly the table's length both run."""
    cfg = dict(TINY, motion_num_token=1)
    jmod = ja2m.A2MModelCrossAttnAudio(cfg=ja2m.A2MConfig(**cfg))
    tmod = ta2m.A2MModelCrossAttnAudio(ta2m.A2MConfig(**cfg), device="cpu")
    for l, fits in ((1, True), (2, False)):
        x = _inputs(n=1, l=l)
        args = (jnp.asarray(x[0]), jnp.asarray(x[1]))
        kw = dict(audio=jnp.asarray(x[2]), ref_audio=jnp.asarray(x[3]))

        def jax_init():
            return jax.eval_shape(lambda: jmod.init(
                {"params": common.KEY, "noise": common.KEY}, *args, **kw))
        if fits:
            jax_init()
            with torch.no_grad():
                tmod(_t(x[0]), _t(x[1]), audio=_t(x[2]), ref_audio=_t(x[3]))
            continue
        with pytest.raises(TypeError, match="broadcast"):
            jax_init()
        with pytest.raises(ValueError, match=r"2 motion tokens.*"
                           r"motion_num_token 1"):
            tmod(_t(x[0]), _t(x[1]), audio=_t(x[2]), ref_audio=_t(x[3]))


# -- the flagship on meta ------------------------------------------------------


def _flagship(tokens):
    with open(FLAGSHIP) as f:
        spec = yaml.safe_load(f)
    assert spec["model_type"] == "A2MModel_CrossAtten_Audio"
    return dict(spec["model"], motion_num_token=tokens)


def _jax_shapes(model_kw, tokens):
    cfg = ja2m.A2MConfig(**model_kw)
    jmod = ja2m.A2MModelCrossAttnAudio(cfg=cfg)
    motion = jax.ShapeDtypeStruct((1, cfg.motion_frames, tokens,
                                   cfg.motion_in_channel), jnp.float32)
    audio = jax.ShapeDtypeStruct((1, cfg.motion_frames, cfg.audio_block,
                                  cfg.audio_inchannel), jnp.float32)
    return jax.eval_shape(lambda m, a: jmod.init(
        {"params": common.KEY, "noise": common.KEY}, m, m[:, 0], audio=a,
        ref_audio=a[:, 0]), motion, audio)


@pytest.mark.parametrize("tokens", [1, 4])
def test_flagship_parameter_count_matches_jax(tokens):
    """The shipped yaml as it is (1 token) and at AMD_N's 4 object tokens:
    ``motion_num_token`` sizes no weight, so both have 361.2 M."""
    kw = _flagship(tokens)
    shapes = _jax_shapes(kw, tokens)
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    port = ta2m.A2MModelCrossAttnAudio(ta2m.A2MConfig(**kw), device="meta")
    got = sum(p.numel() for p in port.parameters())
    assert got == want and round(got / 1e5) == 3612


def test_flagship_int8_table_matches_jax():
    """The ``a2m`` scope's layers and shapes, as the JAX package's
    ``quantize_params`` selects them on the ``eval_shape`` tree."""
    kw = _flagship(4)
    shapes = _jax_shapes(kw, 4)
    jt = jax.eval_shape(lambda p: jq.quantize_params(
        p, scope=("diffusion",)), shapes)
    tt = tq.quantize_params(
        ta2m.A2MModelCrossAttnAudio(ta2m.A2MConfig(**kw), device="meta"),
        scope=tpipe.QUANT_SCOPES["a2m"])
    want = {}
    for path, e in jt.items():
        key = flax_path_to_torch_key(tuple(path.split("/")) + ("kernel",))
        want[key[:-len(".weight")]] = e["w8"].shape[::-1]
    assert {k: tuple(e["w8"].shape) for k, e in tt.items()} == want
    # 16 blocks (8 self, 8 cross): q, k, v, out, FFN up and down; the
    # motion, reference and audio embeddings and the output projection
    assert collections.Counter(tuple(e["w8"].shape) for e in tt.values()) \
        == {(1024, 1024): 65, (4096, 1024): 16, (1024, 4096): 16,
            (1024, 512): 2, (512, 1024): 1}
