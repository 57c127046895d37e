"""The port's other A2M heads (``models/a2m.py``: ``A2MModelLearnableToken``
in both block forms, ``A2MModelPosePre``, ``A2MModelMlp`` and
``sample_grid``) and their blocks against the JAX package's, fp32 on the
CPU at tiny widths:

  * ``get_3d_sincos_pos_embed`` bit for bit;
  * ``AdaLNZeroTriple``, ``JointBlock2Condition[Simple]``,
    ``A2PTemporalSpatialBlock``, ``A2PCrossAudioBlock``, ``Mlp`` (exact
    GELU) and ``AudioFeatureMlp``;
  * each head's ``conditions``, ``velocity`` and training loss, the
    timestep injected on both sides and the flow noise, drawn with numpy,
    replayed into ``jax.random.normal``;
    ``predict_pose``; the grid head with a 4 x 2 motion grid, whose 3-D
    table the JAX package builds over (4, 4) patches;
  * ``sample`` with each new head and ``sample_grid``, the start noise
    drawn with numpy and replayed into both (``SampleDraws`` on the
    port's side);
  * the bridge: every JAX leaf of every head maps onto a port parameter
    of its shape (``temporal_spatial_blocks_i``, ``pose_mask_token``,
    ``mlp/fc1``, ``norm1_condition1``, the ``PatchEmbed`` projections);
  * PosePre's ``conditions`` without ``ref_pose``: a ``ValueError`` naming
    it where the JAX head fails on a None;
  * on ``meta`` against ``jax.eval_shape``: the parameter counts of the
    PosePre yaml, of LearnableToken and SimpleAdaLN at the flagship
    yaml's widths and of the grid head at the ``A2MConfig`` defaults, the
    new heads' int8 ``a2m`` tables, and the routes of their attentions
    (the heads' own stay plain; the grid head's joint block, 528 tokens,
    takes the full-block kernel).

Parameters come from ``jax.eval_shape`` filled from a numpy seed
(``test_torch_amd_family_models.random_params``) and load with
``strict=True``; each JAX call is jitted afresh (one compile costs less
than the eager first calls of its ops). Outputs within
``test_torch_models.TOL`` (2e-4), samples within ``test_torch_serving.TOL``
(1e-3), losses within 2e-4 relative."""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_serving as common
from hivae_tpu.models import a2m as ja2m
from hivae_tpu.models import blocks as jblocks
from hivae_tpu.ops import embeddings as jemb
from hivae_tpu.ops import quant as jq
from hivae_tpu_torch.models import a2m as ta2m
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import blocks as tblocks
from hivae_tpu_torch.ops import attention as tattn
from hivae_tpu_torch.ops import embeddings as temb
from hivae_tpu_torch.ops import quant as tq
from hivae_tpu_torch.pipelines import pipeline as tpipe
from hivae_tpu_torch.utils.params import flax_path_to_torch_key, flax_to_torch
from test_torch_a2m import FLAGSHIP, _rand, _t
from test_torch_amd_family import _one_thread  # noqa: F401
from test_torch_amd_family_models import random_params
from test_torch_models import _close
from test_torch_training import _replay

N, F_, L, D = 2, 4, 2, 16
M, C = 3, 8
POSE = 8
# the tiny heads: (M, C) audio features a frame, L tokens of D, 8x8 pose
# latents in 2x2 patches; the grid head's 4 x 2 grids of D channels and
# its 8x8 reference latents
TINY = dict(audio_inchannel=C, audio_block=M, motion_num_token=L,
            motion_in_channel=D, motion_frames=F_, window_size=2,
            encoder_out_dim=16, intermediate_dim=24,
            diffusion_attn_head_dim=8, diffusion_attn_num_heads=2,
            diffusion_num_layers=2, pose_height=POSE, pose_width=POSE,
            pose_inchannel=4, pose_patch_size=2,
            pose_predictor_attn_head_dim=8,
            pose_predictor_attn_num_heads=2,
            pose_predictor_attn_num_layers=2, motion_height=4,
            motion_width=2, image_inchannel=4, image_height=POSE,
            image_width=POSE, image_patch_size=2, time_embed_dim=24)
POSEPRE = "configs/a2m/cross_audio_posepre_t1d512_l16_dim1024.yaml"
_BUILT = {}


def _tokens(seed):
    """(motion (N, F, L, D), ref motion, audio, ref audio, pose, ref
    pose)."""
    return (_rand(N, F_, L, D, seed=seed), _rand(N, L, D, seed=seed + 1),
            _rand(N, F_, M, C, seed=seed + 2), _rand(N, M, C, seed=seed + 3),
            _rand(N, F_, 4, POSE, POSE, seed=seed + 4),
            _rand(N, 4, POSE, POSE, seed=seed + 5))


def _grid_inputs(seed):
    """(motion grids (N, F, D, 4, 2), reference image latents, audio,
    reference pose latents)."""
    return (_rand(N, F_, D, 4, 2, seed=seed),
            _rand(N, 4, POSE, POSE, seed=seed + 1),
            _rand(N, F_, M, C, seed=seed + 2),
            _rand(N, 4, POSE, POSE, seed=seed + 3))


def _japply(jmod, *args, method="__call__", **kw):
    """``jmod.apply`` jitted afresh (one compile is quicker than the ops'
    eager first calls; a fresh trace reads the draws replayed now)."""
    return jax.jit(lambda *a, **k: jmod.apply(*a, method=method, **k))(
        *args, **kw)


def _jnp(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _torch(kw):
    return {k: _t(v) for k, v in kw.items()}


def _cond_kw(name, x):
    _, _, audio, ref_audio, pose, ref_pose = x
    if name == "posepre":
        return dict(audio=audio, ref_audio=ref_audio, pose=pose,
                    ref_pose=ref_pose)
    return dict(audio=audio, ref_audio=ref_audio)


def _modules(name, cfg, device="cpu"):
    """(flax module, port module) of head ``name`` for the config dict."""
    jcfg, tcfg = ja2m.A2MConfig(**cfg), ta2m.A2MConfig(**cfg)
    if name in ("learnable", "simple_adaln"):
        simple = name == "simple_adaln"
        return (ja2m.A2MModelLearnableToken(cfg=jcfg, simple_adaln=simple),
                ta2m.A2MModelLearnableToken(tcfg, simple, device=device))
    if name == "posepre":
        return (ja2m.A2MModelPosePre(cfg=jcfg),
                ta2m.A2MModelPosePre(tcfg, device=device))
    return ja2m.A2MModelMlp(cfg=jcfg), ta2m.A2MModelMlp(tcfg, device=device)


def head(name):
    """(flax module, params, port module) of a tiny head, built once a
    module."""
    if name not in _BUILT:
        jmod, tmod = _modules(name, TINY)
        if name == "grid":
            g = _grid_inputs(0)
            params = random_params(jmod, *map(jnp.asarray, g[:3]),
                                   ref_pose=jnp.asarray(g[3]))
        else:
            x = _tokens(0)
            params = random_params(jmod, jnp.asarray(x[0]),
                                   jnp.asarray(x[1]),
                                   **_jnp(_cond_kw(name, x)))
        tmod.load_state_dict(flax_to_torch(params), strict=True)
        _BUILT[name] = (jmod, params, tmod.eval())
    return _BUILT[name]


# -- the 3-D position table ----------------------------------------------------


@pytest.mark.parametrize("args", [(16, (2, 2), 4), (64, (4, 4), 16),
                                  (1024, (4, 4), 16), (32, (3, 5), 2)])
def test_3d_sincos_table_bit_equal(args):
    got = temb.get_3d_sincos_pos_embed(*args)
    want = jemb.get_3d_sincos_pos_embed(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# -- the blocks ----------------------------------------------------------------

DIM, HEADS, HD, COND = 16, 2, 8, 12
BLOCKS = {
    "adaln_triple": (lambda: jblocks.AdaLNZeroTriple(DIM),
                     lambda: tblocks.AdaLNZeroTriple(DIM, COND)),
    "joint2": (lambda: jblocks.JointBlock2Condition(DIM, HEADS, HD),
               lambda: tblocks.JointBlock2Condition(DIM, HEADS, HD, COND)),
    "joint2_simple": (
        lambda: jblocks.JointBlock2ConditionSimple(DIM, HEADS, HD),
        lambda: tblocks.JointBlock2ConditionSimple(DIM, HEADS, HD, COND)),
    "a2p_temporal_spatial": (
        lambda: jblocks.A2PTemporalSpatialBlock(DIM, HEADS, HD),
        lambda: tblocks.A2PTemporalSpatialBlock(DIM, HEADS, HD)),
    "a2p_cross_audio": (lambda: jblocks.A2PCrossAudioBlock(DIM, HEADS, HD),
                        lambda: tblocks.A2PCrossAudioBlock(DIM, HEADS, HD)),
    "mlp": (lambda: jblocks.Mlp(24, DIM), lambda: tblocks.Mlp(DIM, 24, DIM)),
    "audio_feature_mlp": (lambda: jblocks.AudioFeatureMlp(outdim=DIM),
                          lambda: tblocks.AudioFeatureMlp(M * C, DIM)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_blocks_match_jax(name):
    jmod, tmod = (make() for make in BLOCKS[name])
    streams = (_rand(N, 12, DIM, seed=1), _rand(N, 5, DIM, seed=2),
               _rand(N, 3, DIM, seed=3))
    temb_ = _rand(N, COND, seed=4)
    frames = _rand(N, F_, 6, DIM, seed=5)
    args = {"adaln_triple": streams + (temb_,), "joint2": streams + (temb_,),
            "joint2_simple": streams + (temb_,),
            "a2p_temporal_spatial": (frames,),
            "a2p_cross_audio": (frames, _rand(N, F_, 3, DIM, seed=6)),
            "mlp": (_rand(N, 5, DIM, seed=7) * 2,),
            "audio_feature_mlp": (_rand(N, F_, M, C, seed=8),)}[name]
    params = random_params(jmod, *map(jnp.asarray, args))
    want = _japply(jmod, params, *map(jnp.asarray, args))
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        got = tmod.eval()(*map(_t, args))
    _close(got, want)


# -- the heads -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["learnable", "simple_adaln", "posepre"])
def test_conditions_and_velocity_match_jax(name):
    jmod, params, tmod = head(name)
    x = _tokens(10)
    kw = _cond_kw(name, x)
    jcond = _japply(jmod, params, method="conditions", **_jnp(kw))
    with torch.no_grad():
        tcond = tmod.conditions(**_torch(kw))
    assert tcond.keys() == jcond.keys()
    for k in tcond:
        _close(tcond[k], jcond[k])
    ts = np.array([0.0, 613.0], np.float32)
    want = _japply(jmod, params, jnp.asarray(x[0]), jnp.asarray(x[1]),
                   jnp.asarray(ts), method="velocity", **jcond)
    with torch.no_grad():
        got = tmod.velocity(_t(x[0]), _t(x[1]), _t(ts), **tcond)
    assert got.shape == (N, F_, L, D)
    _close(got, want)


def test_grid_velocity_matches_jax():
    """The grid DiT on 4 x 2 grids: the JAX package slices its 3-D table,
    built over (4, 4) patches, to the 8 patches a frame; so does the
    port."""
    jmod, params, tmod = head("grid")
    motion, ref_img, audio, ref_pose = _grid_inputs(10)
    jfeat = _japply(jmod, params, jnp.asarray(audio), method="encode_audio")
    with torch.no_grad():
        tfeat = tmod.encode_audio(_t(audio))
    _close(tfeat, jfeat)
    ts = np.array([3.0, 700.0], np.float32)
    want = _japply(jmod, params, jnp.asarray(motion), jnp.asarray(ref_img),
                   jnp.asarray(ref_pose), jfeat, jnp.asarray(ts),
                   method="velocity")
    with torch.no_grad():
        got = tmod.velocity(_t(motion), _t(ref_img), _t(ref_pose), tfeat,
                            _t(ts))
    assert got.shape == motion.shape
    _close(got, want)


@pytest.mark.parametrize("name", ["learnable", "simple_adaln", "posepre",
                                  "grid"])
def test_training_loss_matches_jax(name):
    """The training forward at injected timesteps (the grid head's
    ``time_step``) and flow noise; the token heads' per-frame mask,
    PosePre's pose MSE."""
    jmod, params, tmod = head(name)
    ts = np.array([17, 980], np.int32)
    mask = np.array([[1, 0, 1, 1], [0, 1, 1, 0]], np.float32)
    rngs = {"noise": jax.random.PRNGKey(5)}
    if name == "grid":
        g = _grid_inputs(20)
        noise = _rand(*g[0].shape, seed=25)
        with _replay(normal=[noise]):
            want = _japply(jmod, params, *map(jnp.asarray, g[:3]),
                           ref_pose=jnp.asarray(g[3]),
                           time_step=jnp.asarray(ts), rngs=rngs)
        got = tmod(*map(_t, g[:3]), ref_pose=_t(g[3]),
                   time_step=_t(ts).long(), noise=_t(noise))
    else:
        x = _tokens(20)
        kw = _cond_kw(name, x)
        noise = _rand(*x[0].shape, seed=25)
        with _replay(normal=[noise]):
            want = _japply(jmod, params, jnp.asarray(x[0]),
                           jnp.asarray(x[1]), mask=jnp.asarray(mask),
                           timestep=jnp.asarray(ts), rngs=rngs, **_jnp(kw))
        got = tmod(_t(x[0]), _t(x[1]), mask=_t(mask),
                   timestep=_t(ts).long(), z0=_t(noise), **_torch(kw))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=2e-4)


def test_predict_pose_matches_jax():
    jmod, params, tmod = head("posepre")
    x = _tokens(30)
    want = _japply(jmod, params, jnp.asarray(x[2]), jnp.asarray(x[3]),
                   jnp.asarray(x[5]), method="predict_pose")
    with torch.no_grad():
        got = tmod.predict_pose(_t(x[2]), _t(x[3]), _t(x[5]))
    assert got.shape == (N, F_ + 1, 4, POSE, POSE)
    _close(got, want)


def test_posepre_without_ref_pose_refused():
    """The JAX head fails on ``None.shape`` deep in its pose predictor;
    the port names the missing input. So does a pose-conditioned cross
    head."""
    jmod, params, tmod = head("posepre")
    x = _tokens(40)
    with pytest.raises(AttributeError, match="NoneType"):
        jmod.apply(params, audio=jnp.asarray(x[2]),
                   ref_audio=jnp.asarray(x[3]), method="conditions")
    with pytest.raises(ValueError, match="missing: ref_pose"):
        tmod.conditions(audio=_t(x[2]), ref_audio=_t(x[3]))
    cross = ta2m.A2MModelCrossAttnAudio(ta2m.A2MConfig(**TINY), "audio_pose",
                                        device="cpu")
    with pytest.raises(ValueError, match="missing: pose, ref_pose"):
        cross.conditions(audio=_t(x[2]), ref_audio=_t(x[3]))


@pytest.mark.parametrize("name", ["learnable", "simple_adaln", "posepre"])
def test_sample_matches_jax(name):
    """The generic ``sample`` serves each new head (PosePre with its
    reference pose)."""
    jmod, params, tmod = head(name)
    x = _tokens(50)
    kw = {k: v for k, v in _cond_kw(name, x).items() if k != "pose"}
    z0 = _rand(N, F_, L, D, seed=55)
    with _replay(normal=[z0]):
        want = jax.jit(ja2m.sample, static_argnums=(0,), static_argnames=(
            "frames", "sample_step"))(jmod, params, jax.random.PRNGKey(7),
                                      jnp.asarray(x[1]), frames=F_,
                                      sample_step=3, **_jnp(kw))
    got = ta2m.sample(tmod, _t(x[1]), F_, sample_step=3,
                      generator=tamd.SampleDraws(replay=[z0]),
                      **_torch(kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **common.TOL)


def test_sample_grid_matches_jax():
    jmod, params, tmod = head("grid")
    _, ref_img, audio, ref_pose = _grid_inputs(60)
    z0 = _rand(N, F_, D, 4, 2, seed=65)
    with _replay(normal=[z0]):
        want = jax.jit(ja2m.sample_grid, static_argnums=(0,),
                       static_argnames=("sample_step",))(
            jmod, params, jax.random.PRNGKey(9), jnp.asarray(ref_img),
            jnp.asarray(audio), ref_pose=jnp.asarray(ref_pose),
            sample_step=3)
    got = ta2m.sample_grid(tmod, _t(ref_img), _t(audio), _t(ref_pose),
                           sample_step=3,
                           generator=tamd.SampleDraws(replay=[z0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **common.TOL)


@pytest.mark.parametrize("name", ["learnable", "simple_adaln", "posepre",
                                  "grid"])
def test_bridge_maps_every_jax_leaf(name):
    _, params, tmod = head(name)
    mapped = flax_to_torch(params)
    assert len(mapped) == len(jax.tree_util.tree_leaves(params))
    state = tmod.state_dict()
    assert mapped.keys() == state.keys()
    for k, v in mapped.items():
        assert tuple(v.shape) == tuple(state[k].shape), k
    if name == "posepre":
        assert "pose_predictor.pose_mask_token" in state
        assert "pose_predictor.temporal_spatial_blocks.1.attn2.to_q.weight" \
            in state


# -- full widths on meta -------------------------------------------------------


def _spec(path, model_type=None):
    with open(path) as f:
        spec = yaml.safe_load(f)
    return model_type or spec["model_type"], spec["model"]


FULL = {
    # (yaml, the model_type to build it as, the head, frames, tokens)
    "posepre": (POSEPRE, None, 16, 1),
    "learnable": (FLAGSHIP, "A2MModel_LearnableToken", 16, 4),
    "simple_adaln": (FLAGSHIP, "A2MModel_SimpleAdaLN", 16, 4),
    "grid": (None, None, 16, None),
}
# the parameter counts, in units of 1e5, of each head at full width
FULL_COUNTS = {"posepre": 5425, "learnable": 2016, "simple_adaln": 1512,
               "grid": 1947}


@functools.lru_cache(maxsize=None)
def _full(name):
    """(JAX eval_shape params, port module on meta, config dict), built
    once a module."""
    path, model_type, frames, tokens = FULL[name]
    cfg = {} if path is None else dict(_spec(path, model_type)[1])
    if tokens is not None:
        cfg["motion_num_token"] = tokens
    jmod, tmod = _modules(name, cfg, device="meta")
    c = jmod.cfg
    audio = jnp.zeros((1, frames, c.audio_block, c.audio_inchannel))
    if name == "grid":
        motion = jnp.zeros((1, frames, c.motion_in_channel, c.motion_height,
                            c.motion_width))
        img = jnp.zeros((1, c.image_inchannel, c.image_height,
                         c.image_width))
        args, kw = (motion, img, audio), {}
    else:
        motion = jnp.zeros((1, frames, tokens, c.motion_in_channel))
        args = (motion, motion[:, 0])
        kw = dict(audio=audio, ref_audio=audio[:, 0])
        if name == "posepre":
            pose = jnp.zeros((1, frames, c.pose_inchannel, c.pose_height,
                              c.pose_width))
            kw.update(pose=pose, ref_pose=pose[:, 0])
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": common.KEY, "noise": common.KEY}, *args, **kw))
    return shapes, tmod, cfg


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_parameter_count_matches_jax(name):
    shapes, tmod, _ = _full(name)
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    got = sum(p.numel() for p in tmod.parameters())
    assert got == want and round(got / 1e5) == FULL_COUNTS[name]


@pytest.mark.parametrize("name", ["learnable", "simple_adaln", "posepre"])
def test_full_width_int8_table_matches_jax(name):
    """The ``a2m`` scope's layers and shapes, as the JAX package's
    ``quantize_params`` selects them on the ``eval_shape`` tree."""
    shapes, tmod, _ = _full(name)
    jt = jax.eval_shape(lambda p: jq.quantize_params(
        p, scope=("diffusion",)), shapes)
    tt = tq.quantize_params(tmod, scope=tpipe.QUANT_SCOPES["a2m"])
    want = {}
    for path, e in jt.items():
        key = flax_path_to_torch_key(tuple(path.split("/")) + ("kernel",))
        want[key[:-len(".weight")]] = e["w8"].shape[::-1]
    assert {k: tuple(e["w8"].shape) for k, e in tt.items()} == want
    if name != "posepre":
        # 8 blocks: q, k, v, out, FFN up and down; the audio embedding,
        # the motion and reference embeddings and the output projection
        assert collections.Counter(tuple(e["w8"].shape)
                                   for e in tt.values()) == {
            (1024, 1024): 33, (4096, 1024): 8, (1024, 4096): 8,
            (1024, 512): 2, (512, 1024): 1}


def _route(shape, sk=None, dtype=torch.bfloat16):
    q = torch.empty(shape, dtype=dtype, device="meta")
    k = torch.empty(shape[:2] + (sk or shape[2], shape[3]), dtype=dtype,
                    device="meta")
    return tattn.kernel_route(q, k)


def test_attention_routes_on_meta():
    """On the card (``meta`` stands in for it): the heads' own attentions
    at full width go plain, as the JAX package sends them to XLA; the
    grid head's joint block (16 x 16 motion patches, 256 image patches,
    16 audio tokens) takes the full-block kernel in bf16, fp32 and fp16;
    the same shape at D 2056, past every kernel's tiles, no kernel."""
    plain = {
        "LearnableToken joint (64 + 4 + 16)": (4, 16, 84, 64),
        "A2P temporal (17 frames)": (4 * 256, 8, 17, 64),
        "A2P spatial (256 patches)": (4 * 17, 8, 256, 64),
    }
    for label, shape in plain.items():
        assert _route(shape) == "plain", label
    assert _route((4 * 17, 8, 256, 64), sk=32) == "plain"
    assert _route((4, 16, 528, 64)) == "full_block"
    before = tattn.sdpa_plain.launches
    assert _route((4, 16, 528, 64), dtype=torch.float32) == "full_block"
    assert _route((4, 16, 528, 64), dtype=torch.float16) == "full_block"
    assert _route((4, 16, 528, 2056), dtype=torch.float16) == "plain"
    assert tattn.sdpa_plain.launches == before


def test_grid_joint_launch_plan_fits():
    """The grid head's joint block, S 528 at D 64, is a new shape for the
    full-block kernels: admitted, and its forward's and backward's plans
    within a block's 232,448 bytes of shared memory."""
    from hivae_tpu_torch.ops.kernels import flash_attention as tfa
    shape = (4, 16, 528, 64)
    assert tattn.full_block_fits(shape, shape)
    plan = tfa._full_block_plan(528, 528, 64)
    assert plan.fwd_smem <= tfa.SMEM_PER_BLOCK == 232_448
    assert plan.bwd_smem <= tfa.SMEM_PER_BLOCK
    assert plan.bwd_stages == tfa.FULL_BLOCK_STAGES
