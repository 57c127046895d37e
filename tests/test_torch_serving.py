"""The port's sampling drivers (``models/amd.py``), Heun solver and
static-ratio token masking against the JAX package's, on the tiny flagship
AMD_N in fp32 on the CPU.

The JAX side records its draws as they are made (ordered debug
callbacks): each static-ratio mask's uniform draw (in
``random_mask_tokens``) and each ODE start noise (``jax.random.normal``), in
call order. The port replays them through ``SampleDraws``, so the two
PRNGs do not enter the comparison.

Tolerance: latents within ``TOL`` (1e-3 absolute and relative): the
frameworks sum in other orders and flax's norms take the fast variance,
and each ODE step carries the difference on. Token gathers and step
sequences are exact. The helpers here also serve the other serving test
files (``test_torch_serving_pipelines.py``, ``test_torch_serving_io.py``).
"""

import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from hivae_tpu.models import amd as jamd
from hivae_tpu.models import motion_encoders as jenc
from hivae_tpu.ops import rectified_flow as jrf
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import motion_encoders as tenc
from hivae_tpu_torch.ops import rectified_flow as trf
from hivae_tpu_torch.utils.params import flax_to_torch

FRAMES = 4
LAT = 16
KEY = jax.random.PRNGKey(0)
TOL = dict(atol=1e-3, rtol=1e-3)


def perturb(params, seed):
    """flax inits zero biases, unit norms and zero tokens: perturb every
    leaf so a mis-mapped parameter cannot hide behind its init value."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*np.shape(x)).astype(
            np.float32), params)


def tiny_amd(frames=FRAMES):
    """(flax module, perturbed params, port module) of the tiny flagship."""
    jmod = graft._flagship(tiny=True, frames=frames)
    v = jnp.zeros((1, frames, 4, LAT, LAT))
    params = perturb(jax.device_get(jax.jit(jmod.init)(
        {"params": KEY, "noise": KEY}, v, v, v, v)), 1)
    tmod = tamd.AMDModelNew(tamd.AMDConfig.from_dict(jmod.cfg.to_dict()),
                            device="cpu")
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    return jmod, params, tmod.eval()


@contextlib.contextmanager
def recorded_draws(monkeypatch):
    """Record the JAX package's sampling draws in call order, as they are
    made: the uniform each ``random_mask_tokens`` argsorts and each
    ``jax.random.normal`` drawn while sampling (ordered debug callbacks,
    so jitted code records too; the compilation caches are cleared first
    so that every program is traced with the recorders in place)."""
    draws = []
    orig_mask, orig_normal = jenc.random_mask_tokens, jax.random.normal

    def record(x):
        jax.debug.callback(lambda v: draws.append(np.array(v)), x,
                           ordered=True)

    def mask(key, x, mask_ratio, axis=1):
        record(jax.random.uniform(key, (x.shape[0], x.shape[axis])))
        return orig_mask(key, x, mask_ratio, axis)

    def normal(key, shape=(), dtype=jnp.float32):
        out = orig_normal(key, shape, dtype)
        record(out)
        return out

    monkeypatch.setattr(jenc, "random_mask_tokens", mask)
    monkeypatch.setattr(jax.random, "normal", normal)
    jax.clear_caches()
    yield draws
    jax.effects_barrier()
    monkeypatch.setattr(jax.random, "normal", orig_normal)
    jax.clear_caches()


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def amd():
    return tiny_amd()


def _clip(seed):
    """(video, ref, video_grey, ref_grey) latents (1, FRAMES, 4, LAT, LAT),
    the refs one frame tiled."""
    shape = (1, FRAMES, 4, LAT, LAT)
    video, grey = rand(*shape, seed=seed), rand(*shape, seed=seed + 1)
    ref = np.broadcast_to(rand(1, 1, 4, LAT, LAT, seed=seed + 2), shape)
    gref = np.broadcast_to(rand(1, 1, 4, LAT, LAT, seed=seed + 3), shape)
    return video, np.ascontiguousarray(ref), grey, np.ascontiguousarray(gref)


@pytest.mark.parametrize("steps,start", [(10, None), (7, 500), (4, 999),
                                         (1, None)])
def test_scheduler_step_sequence_matches_jax(steps, start):
    want = jrf.scheduler_step_sequence(steps, start)
    got = trf.scheduler_step_sequence(steps, start)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seq", [[1000, 500], [1000, 750, 500, 250],
                                 [600]])
def test_heun_sample_matches_jax(seq):
    """A velocity field that depends on z and t; Heun's last step corrects
    toward step 0."""
    z0 = rand(3, 4, seed=5)
    w = rand(4, 4, seed=6) * 0.3

    def jvel(z, tstep):
        return jnp.tanh(z @ w) * (1.0 + tstep[:, None] / 1000.0)

    def tvel(z, tstep):
        return torch.tanh(z @ t(w)) * (1.0 + tstep[:, None] / 1000.0)

    want = jrf.heun_sample(jvel, jnp.asarray(z0), seq)
    got = trf.heun_sample(tvel, t(z0), seq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("shape,axis,ratio", [
    ((3, 64, 8), 1, 0.5), ((2, 4, 64, 8), 2, 0.25),
    # 10 * (1 - 0.9) is 0.99... in Python floats (0 kept), 1.0000002 in
    # float32 (1 kept): the count follows the Python float
    ((2, 10, 4), 1, 0.9)])
def test_random_mask_tokens_matches_jax(shape, axis, ratio):
    x = rand(*shape, seed=7)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jenc.random_mask_tokens(key, jnp.asarray(x), ratio,
                                              axis=axis))
    u = np.asarray(jax.random.uniform(key, (shape[0], shape[axis])))
    got = tenc.random_mask_tokens(t(x), ratio, axis=axis, u=t(u))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("solver,cam,obj", [
    ("euler", None, None), ("heun", 0.5, 0.5), ("euler", 0.25, None)])
def test_sample_matches_jax(amd, monkeypatch, solver, cam, obj):
    jmod, params, tmod = amd
    video, ref, grey, gref = _clip(10)
    with recorded_draws(monkeypatch) as draws:
        want = jamd.sample_jit(jmod, params, jax.random.PRNGKey(4),
                               jnp.asarray(video), jnp.asarray(ref),
                               jnp.asarray(grey), jnp.asarray(gref),
                               sample_step=2, camera_mask_ratio=cam,
                               object_mask_ratio=obj, solver=solver)
    assert len(draws) == 1 + (cam is not None) + (obj is not None)
    got = tamd.sample(tmod, t(video), t(ref), t(grey), t(gref),
                      sample_step=2, camera_mask_ratio=cam,
                      object_mask_ratio=obj, solver=solver,
                      generator=tamd.SampleDraws(replay=draws))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("single_ref,start", [(True, None), (False, 600)])
def test_decode_matches_jax(amd, monkeypatch, single_ref, start):
    """A single reference frame is tiled; below the full range the walk
    starts from the partially noised ``video``."""
    jmod, params, tmod = amd
    video, ref, grey, gref = _clip(20)
    motions = jax.jit(partial(jmod.apply, method="encode"))(
        params, *map(jnp.asarray, (video, ref, grey, gref)))
    names = ("camera_target", "object_source", "object_target")
    r = ref[:, :1] if single_ref else ref
    with recorded_draws(monkeypatch) as draws:
        want = jax.jit(lambda k: jamd.decode(
            jmod, params, k, jnp.asarray(r), dict(zip(names, motions)),
            FRAMES, sample_step=2, start_step=start,
            video=jnp.asarray(video), solver="heun"))(jax.random.PRNGKey(5))
    got = tamd.decode(tmod, t(r), {n: t(m) for n, m in zip(names, motions)},
                      FRAMES, sample_step=2, start_step=start, video=t(video),
                      solver="heun", generator=tamd.SampleDraws(replay=draws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="frames"):
        tamd.decode(tmod, t(ref[:, :2]), {}, FRAMES)


@pytest.mark.parametrize("mask_ratio", [None, 0.5])
def test_sample_with_refimg_motion_matches_jax(amd, monkeypatch, mask_ratio):
    jmod, params, tmod = amd
    ref_img = rand(1, 4, LAT, LAT, seed=30)
    motion = rand(1, FRAMES, 4, 32, seed=31)
    with recorded_draws(monkeypatch) as draws:
        want = jamd.sample_with_refimg_motion_jit(
            jmod, params, jax.random.PRNGKey(6), jnp.asarray(ref_img),
            jnp.asarray(motion), sample_step=2, mask_ratio=mask_ratio)
    assert len(draws) == 1 + (mask_ratio is not None)
    got = tamd.sample_with_refimg_motion(
        tmod, t(ref_img), t(motion), sample_step=2, mask_ratio=mask_ratio,
        generator=tamd.SampleDraws(replay=draws))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("camera_mask_ratio", [None, 0.5])
def test_sample_cross_matches_jax(amd, monkeypatch, camera_mask_ratio):
    jmod, params, tmod = amd
    video_1, _, grey_1, _ = _clip(40)
    video_2, ref, _, _ = _clip(50)
    with recorded_draws(monkeypatch) as draws:
        want = jamd.sample_cross_jit(
            jmod, params, jax.random.PRNGKey(7), jnp.asarray(video_1),
            jnp.asarray(video_2), jnp.asarray(ref),
            video_grey_1=jnp.asarray(grey_1), sample_step=2,
            camera_mask_ratio=camera_mask_ratio, solver="heun")
    got = tamd.sample_cross(tmod, t(video_1), t(video_2), t(ref),
                            video_grey_1=t(grey_1), sample_step=2,
                            camera_mask_ratio=camera_mask_ratio,
                            solver="heun",
                            generator=tamd.SampleDraws(replay=draws))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("mask_ratio", [None, 0.5])
def test_extract_motion_matches_jax(amd, monkeypatch, mask_ratio):
    jmod, params, tmod = amd
    video = rand(1, FRAMES, 4, LAT, LAT, seed=60)
    key = None if mask_ratio is None else jax.random.PRNGKey(8)
    with recorded_draws(monkeypatch) as draws:
        want = jamd.extract_motion_jit(jmod, params, jnp.asarray(video),
                                       mask_ratio=mask_ratio, key=key)
    gen = None if mask_ratio is None else tamd.SampleDraws(replay=draws)
    got = tamd.extract_motion(tmod, t(video), mask_ratio, generator=gen)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_extract_motion_needs_a_draw_source_when_masking(amd):
    with pytest.raises(ValueError, match="generator"):
        tamd.extract_motion(amd[2], torch.zeros(1, FRAMES, 4, LAT, LAT), 0.5)


def test_sample_rejects_unknown_solver_and_short_replay(amd):
    video, ref, grey, gref = map(t, _clip(70))
    with pytest.raises(ValueError, match="solver"):
        tamd.sample(amd[2], video, ref, grey, gref, sample_step=1,
                    solver="rk4")
    with pytest.raises(ValueError, match="shape"):
        tamd.sample(amd[2], video, ref, grey, gref, sample_step=1,
                    generator=tamd.SampleDraws(replay=[np.zeros(3)]))


def test_sample_refuses_camera_mask(amd):
    """The optical-flow camera mask belongs to ``use_mask`` models, which
    the port does not build yet: ``sample`` refuses it rather than
    ignoring it."""
    video, ref, grey, gref = map(t, _clip(75))
    with pytest.raises(NotImplementedError, match="use_mask"):
        tamd.sample(amd[2], video, ref, grey, gref, sample_step=1,
                    camera_mask=torch.ones(1, 2 * FRAMES, 4, LAT, LAT))


def test_sample_draws_from_a_generator_are_repeatable(amd):
    video, ref, grey, gref = map(t, _clip(80))

    def run():
        return tamd.sample(amd[2], video, ref, grey, gref, sample_step=1,
                           camera_mask_ratio=0.5, object_mask_ratio=0.5,
                           generator=torch.Generator().manual_seed(3))[1]
    assert torch.equal(run(), run())


def test_config_replace_matches_jax():
    d = graft._flagship(tiny=True).cfg.to_dict()
    got = tamd.AMDConfig.from_dict(d).replace(video_frames=8, use_grey=False)
    want = jamd.AMDConfig.from_dict(d).replace(video_frames=8, use_grey=False)
    assert got.to_dict() == want.to_dict()
