"""The port's training path against the JAX package on the CPU, at a tiny
size: token shuffling, the AMD training forward and its gradients, LPIPS,
the optimizer, one whole trainer step, remat, and the trainer's
checkpoint, resume and NaN handling.

Every random draw is made here with numpy and handed to both sides: the
port takes its draws as inputs (``TrainDraws``, ``StepDraws``); the JAX
package draws inside its modules, so its ``jax.random`` functions are
replaced, for the duration of a call, by ones that return the numpy draws
in the order the package asks for them (``_replay``). Nothing in the JAX
package changes. (The mask draws are reproduced this way, so the encoders
and the DiT are held with the keys masked as the JAX forward masks them.)

fp32 on both sides. Tolerances: losses 1e-5 relative; gradients and LPIPS
within 1e-4 of each tensor's largest element (the two frameworks sum in
different orders, and flax's LayerNorm/GroupNorm take the fast variance
where torch takes the two-pass one); optimizer updates 1e-6 relative, the
same fp32 formulas. A whole Adam step moves each parameter by about lr:
where the gradient is above 1e-4 of the largest one the two sides' moves
agree within 0.2% of lr; below, Adam's g / (|g| + eps) amplifies the
frameworks' fp32 differences, and only the size of the move is held."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from hivae_tpu.losses import losses as jlosses
from hivae_tpu.losses import lpips as jlpips
from hivae_tpu.models import motion_encoders as jenc
from hivae_tpu.models import vae as jvae
from hivae_tpu.training import train_state as jts
from hivae_tpu_torch.losses import losses as tlosses
from hivae_tpu_torch.losses import lpips as tlpips
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import motion_encoders as tenc
from hivae_tpu_torch.models import vae as tvae
from hivae_tpu_torch.ops.kernels import flash_attention as tfa
from hivae_tpu_torch.training import train_state as tts
from hivae_tpu_torch.training import trainer as ttr
from hivae_tpu_torch.utils.device import resolve_device
from hivae_tpu_torch.utils.params import flax_to_torch, lpips_flax_to_torch

KEY = jax.random.PRNGKey(0)
N, T, LAT, PIX = 1, 4, 16, 32
TINY_VAE = dict(block_out_channels=(32, 64), layers_per_block=1,
                norm_num_groups=8)


@contextlib.contextmanager
def _replay(**queues):
    """jax.random.<name> returns the next array of queues[name] instead of
    drawing, for calls of that array's shape; other calls (flax evaluates
    parameter initialisers for their shapes) draw as usual."""
    saved = {name: getattr(jax.random, name) for name in queues}
    left = {name: list(q) for name, q in queues.items()}

    def fake(name):
        def fn(key, shape=(), *args, **kw):
            if left[name] and tuple(jnp.shape(left[name][0])) == tuple(shape):
                return jnp.asarray(left[name].pop(0))
            return saved[name](key, shape, *args, **kw)
        return fn
    for name in queues:
        setattr(jax.random, name, fake(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(jax.random, name, fn)
    assert not any(left.values()), f"unused draws {left}"


def _perturb(params, seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.randn(
        *np.shape(x)).astype(np.float32), params)


def _close_rel(got, want, tol=1e-4, floor=1e-7):
    """Within tol of the tensor's largest element, or of ``floor`` for a
    tensor whose gradient is zero up to rounding (the k-norm bias shifts a
    query's logits all alike, so the softmax cancels its gradient)."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max() + floor, (err, np.abs(want).max())


@dataclasses.dataclass
class Draws:
    ts: np.ndarray          # (N,) per-clip timesteps
    z0: np.ndarray          # (N*T, 4, LAT, LAT)
    cam_u: float
    obj_u: float
    cam_noise: np.ndarray   # (N, sites)
    obj_noise: np.ndarray   # (N*2T, patches)
    posterior: list         # 4 x (N*T, 4, LAT, LAT)

    def port(self, masked):
        perm = lambda x: torch.argsort(torch.from_numpy(x), dim=1, stable=True)
        return tamd.TrainDraws(
            time_step=torch.from_numpy(np.repeat(self.ts, T)),
            z0=torch.from_numpy(self.z0),
            camera_u=torch.tensor(self.cam_u) if masked else None,
            object_u=torch.tensor(self.obj_u) if masked else None,
            camera_perm=perm(self.cam_noise) if masked else None,
            object_perm=perm(self.obj_noise) if masked else None)

    def jax_model(self, masked):
        q = dict(randint=[self.ts], normal=[self.z0])
        if masked:
            q["uniform"] = [np.float32(self.cam_u), np.float32(self.obj_u),
                            self.cam_noise, self.obj_noise]
        return q


def _draws(seed=0):
    rng = np.random.RandomState(seed)
    sites = (LAT // 2) ** 2
    lat = (N * T, 4, LAT, LAT)
    return Draws(ts=rng.randint(0, 1001, (N,)).astype(np.int32),
                 z0=rng.randn(*lat).astype(np.float32),
                 cam_u=float(rng.rand()), obj_u=float(rng.rand()),
                 cam_noise=rng.rand(N, sites).astype(np.float32),
                 obj_noise=rng.rand(N * 2 * T, sites).astype(np.float32),
                 posterior=[rng.randn(*lat).astype(np.float32)
                            for _ in range(4)])


def _jax_value_and_grad(jmod, masked):
    """jit of (params, latents, draws) -> ((loss, loss_dict), grads) of the
    JAX training forward; the draws are arguments, so one compilation
    serves every set of draws."""
    ratios = dict(camera_mask_ratio=jnp.float32(0.5),
                  object_mask_ratio=jnp.float32(0.5)) if masked else {}

    def fn(params, lat, draws):
        def loss_fn(p):
            _, _, ld = jmod.apply(p, *lat, rngs={"noise": KEY, "mask": KEY},
                                  **ratios)
            return ld["loss"], ld
        with _replay(**draws):
            return jax.value_and_grad(loss_fn, has_aux=True)(params)
    return jax.jit(fn)


@pytest.fixture(scope="module")
def tiny():
    jmod = graft._flagship(tiny=True, frames=T)
    v = jnp.zeros((N, T, 4, LAT, LAT))
    params = _perturb(jax.device_get(jax.jit(jmod.init)(
        {"params": KEY, "noise": KEY}, v, v, v, v)))
    cfg = tamd.AMDConfig.from_dict(jmod.cfg.to_dict())
    grad_fns = {m: _jax_value_and_grad(jmod, m) for m in (False, True)}
    return jmod, params, cfg, grad_fns


def _port_model(params, cfg, **over):
    model = tamd.AMDModelNew(dataclasses.replace(cfg, **over), device="cpu")
    model.load_state_dict(flax_to_torch(params), strict=True)
    return model


def _latents(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(N, T, 4, LAT, LAT).astype(np.float32)
            for _ in range(4)]


# -- (d) token shuffling ---------------------------------------------------------


@pytest.mark.parametrize("axis,shape", [(1, (3, 10, 4)), (2, (2, 3, 7, 5))])
def test_shuffle_mask_tokens_matches_jax(axis, shape):
    rng = np.random.RandomState(axis)
    x = rng.randn(*shape).astype(np.float32)
    noise = rng.rand(shape[0], shape[axis]).astype(np.float32)
    ratio = np.float32(0.37)
    with _replay(uniform=[noise]):
        jx, jkeep = jenc.shuffle_mask_tokens(KEY, jnp.asarray(x),
                                             jnp.asarray(ratio), axis=axis)
    perm = torch.argsort(torch.from_numpy(noise), dim=1, stable=True)
    tx, tkeep = tenc.shuffle_mask_tokens(torch.from_numpy(x),
                                         torch.tensor(ratio), axis=axis,
                                         perm=perm)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))


# -- (e) training forward and gradients -------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_training_forward_loss_and_grads_match_jax(tiny, masked):
    _, params, cfg, grad_fns = tiny
    lat = _latents(1)
    d = _draws(2)
    ratios = dict(camera_mask_ratio=0.5, object_mask_ratio=0.5) if masked \
        else {}
    (_, jld), jgrads = grad_fns[masked](params, lat, d.jax_model(masked))
    model = _port_model(params, cfg)
    _, _, ld = model(*map(torch.from_numpy, lat), draws=d.port(masked),
                     **{k: torch.tensor(v) for k, v in ratios.items()})
    ld["loss"].backward()
    for k in ("loss", "diff_loss", "rec_loss"):
        np.testing.assert_allclose(ld[k].item(), float(jld[k]), rtol=1e-5)
    want = flax_to_torch(jax.device_get(jgrads))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        _close_rel(p.grad.numpy(), want[name].numpy())


def test_forward_draws_what_is_not_injected(tiny):
    """Without ``TrainDraws`` the forward draws everything from its
    generator: one seed repeats, another differs."""
    _, params, cfg, _ = tiny
    model = _port_model(params, cfg)
    lat = [torch.from_numpy(x) for x in _latents(13)]

    def loss(seed):
        with torch.no_grad():
            _, _, ld = model(*lat, camera_mask_ratio=torch.tensor(0.5),
                             object_mask_ratio=torch.tensor(0.5),
                             generator=torch.Generator().manual_seed(seed))
        return ld["loss"].item()
    assert loss(1) == loss(1) != loss(2)


# -- (f) LPIPS -------------------------------------------------------------------


def _jax_lpips(shape):
    jmod = jlpips.LPIPS()
    x = jnp.zeros(shape)
    # init gives the heads small random weights; make them positive, as
    # trained LPIPS heads are
    params = jax.tree.map(np.abs, jax.device_get(
        jax.jit(jmod.init)(KEY, x, x)))
    tmod = tlpips.LPIPS()
    tmod.load_state_dict(lpips_flax_to_torch(params), strict=True)
    return jmod, params, tmod.eval()


def test_lpips_forward_and_input_grad_match_jax():
    rng = np.random.RandomState(3)
    x = np.clip(rng.randn(2, 3, 16, 16) * 0.5, -1, 1).astype(np.float32)
    y = np.clip(rng.randn(2, 3, 16, 16) * 0.5, -1, 1).astype(np.float32)
    jmod, params, tmod = _jax_lpips(x.shape)
    jval, jgrad = jax.jit(lambda p, a, b: (
        jmod.apply(p, a, b), jax.grad(lambda a: jmod.apply(p, a, b).sum())(
            a)))(params, jnp.asarray(x), jnp.asarray(y))

    tx = torch.from_numpy(x).requires_grad_()
    tval = tmod(tx, torch.from_numpy(y))
    tval.sum().backward()
    assert tval.shape == (2, 1, 1, 1)
    _close_rel(tval.detach().numpy(), np.asarray(jval))
    _close_rel(tx.grad.numpy(), np.asarray(jgrad))


def test_lpips_mse_loss_matches_jax(tiny_vae):
    jv, vparams, tv = tiny_vae
    jl, lparams, tl = _jax_lpips((1, 3, 16, 16))
    rng = np.random.RandomState(14)
    video = np.clip(rng.randn(1, 2, 3, 16, 16) * 0.5, -1, 1).astype(
        np.float32)
    zj, vp, vg = (rng.randn(2, 4, 8, 8).astype(np.float32) * 0.3
                  for _ in range(3))
    want_loss, want = jax.jit(jlosses.LpipsMseLoss(jv, vparams, jl,
                                                   lparams).__call__)(
        *map(jnp.asarray, (video, zj, vp, vg)))
    with torch.no_grad():
        got_loss, got = tlosses.LpipsMseLoss(tv, tl)(
            *map(torch.from_numpy, (video, zj, vp, vg)))
    for k in ("loss", "rec_loss", "lpips_loss"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4)


# -- (g) the optimizer -----------------------------------------------------------


OPT_CASES = {
    "clip_active": dict(max_grad_norm=0.5),
    "clip_inactive": dict(max_grad_norm=1e3),
    "mu_bf16": dict(mu_dtype="bf16"),
    "warmup": dict(warmup_steps=3),
    "cosine": dict(schedule="cosine", warmup_steps=2, total_steps=7),
    "accumulate_2": dict(accumulate_steps=2),
    "ema": dict(ema_decay=0.9),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    kw = dict(OPT_CASES[case])
    ema = kw.pop("ema_decay", 0.0)
    mu = kw.pop("mu_dtype", None)
    rng = np.random.RandomState(4)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 0.7 for s in shapes]
             for _ in range(4)]

    tx = jts.make_optimizer(learning_rate=1e-2,
                            mu_dtype=jnp.bfloat16 if mu else None, **kw)
    state = jts.TrainState.create([jnp.asarray(p) for p in params], tx,
                                  ema_decay=ema)
    tparams = {str(i): torch.from_numpy(p.copy()) for i, p in
               enumerate(params)}
    ttx = tts.make_optimizer(list(tparams.values()), learning_rate=1e-2,
                             mu_dtype=torch.bfloat16 if mu else None, **kw)
    tstate = tts.TrainState(tparams, ttx, ema_decay=ema)
    for g in grads:
        state = state.apply_gradients([jnp.asarray(x) for x in g])
        tstate.apply_gradients([torch.from_numpy(x) for x in g])
        for got, want in zip(tstate.params.values(), state.params):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        if ema:
            for got, want in zip(tstate.ema_params.values(),
                                 state.ema_params):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)
    assert tstate.step == int(state.step)
    if mu:
        assert all(m.dtype == torch.bfloat16 for m in ttx.mu)


@pytest.mark.parametrize("schedule,warmup,total", [
    ("constant", 0, None), ("constant", 4, None), ("cosine", 3, 10)])
def test_schedules_match_optax(schedule, warmup, total):
    lr = tts.make_schedule(3e-4, warmup, total, schedule)
    if schedule == "constant" and warmup:
        want = optax.join_schedules(
            [optax.linear_schedule(0.0, 3e-4, warmup),
             optax.constant_schedule(3e-4)], [warmup])
    elif schedule == "constant":
        want = optax.constant_schedule(3e-4)
    else:
        want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, total)
    for count in range(12):
        np.testing.assert_allclose(lr(count), float(want(count)), rtol=1e-6)
    assert warmup == 0 or lr(0) == 0.0


# -- (h) one whole step ------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_vae():
    jmod = jvae.AutoencoderKL(cfg=jvae.VAEConfig(**TINY_VAE))
    params = _perturb(jax.device_get(jax.jit(jmod.init)(
        KEY, jnp.zeros((1, 3, PIX, PIX)))), seed=5)
    tmod = tvae.AutoencoderKL(tvae.VAEConfig(**TINY_VAE), device="cpu")
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    return jmod, params, tmod.eval()


def _pixel_batch(seed):
    rng = np.random.RandomState(seed)
    clips = [np.clip(rng.randn(T + 1, 3, PIX, PIX) * 0.5, -1, 1)
             .astype(np.float32) for _ in range(N)]
    grey = [np.repeat(c.mean(1, keepdims=True), 3, 1) for c in clips]
    return ttr.batch_from_clips(clips, grey)


def _port_step_draws(d, masked):
    keys = ("videos", "ref_img", "grey_videos", "ref_grey_img")
    return ttr.StepDraws({k: torch.from_numpy(x)
                          for k, x in zip(keys, d.posterior)}, d.port(masked))


def test_whole_step_matches_jax_step(tiny, tiny_vae, tmp_path):
    _, params, cfg, grad_fns = tiny
    jv, vparams, tv = tiny_vae
    batch = _pixel_batch(6)
    d = _draws(7)
    lr = 1e-3

    # the JAX step, composed from the package's public functions as its
    # trainer composes them
    @jax.jit
    def encode(p, x, noise):
        with _replay(normal=[noise]):
            return jvae.vae_encode(jv, p, x, KEY)

    lat = [encode(vparams, jnp.asarray(batch[k]), noise) for k, noise in
           zip(("videos", "ref_img", "grey_videos", "ref_grey_img"),
               d.posterior)]
    (jloss, _), grads = grad_fns[True](params, lat, d.jax_model(True))
    state = jts.TrainState.create(
        params, jts.make_optimizer(lr, mu_dtype=jnp.bfloat16))
    state = jax.jit(lambda st, g: st.apply_gradients(g))(state, grads)
    jgrad_norm = float(optax.global_norm(grads))

    model = _port_model(params, cfg)
    trainer = ttr.AMDTrainer(model, tv, ttr.TrainConfig(
        output_dir=str(tmp_path), learning_rate=lr, mixed_precision="no",
        mu_dtype="bf16", camera_mask_ratio=0.5, object_mask_ratio=0.5))
    m = trainer.train_step(batch, draws=_port_step_draws(d, True))
    np.testing.assert_allclose(m["loss"], float(jloss), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], jgrad_norm, rtol=1e-4)
    before = flax_to_torch(params)
    after = flax_to_torch(jax.device_get(state.params))
    jgrads = flax_to_torch(jax.device_get(grads))
    g_max = max(g.abs().max().item() for g in jgrads.values())
    for name, p in model.named_parameters():
        moved_j = after[name].numpy() - before[name].numpy()
        moved_t = p.detach().numpy() - before[name].numpy()
        err = np.abs(moved_t - moved_j)
        # where the gradient stands clear of the two sides' fp32 differences
        # (above 1e-4 of the largest gradient) the moves agree closely;
        # below, Adam's g / (|g| + eps) amplifies them, and only the size of
        # the move is held
        clear = np.abs(jgrads[name].numpy()) > 1e-4 * g_max
        assert err[clear].max(initial=0) <= 2e-3 * lr, name
        assert err.max() <= 2.1 * lr, name


# -- (i) remat -------------------------------------------------------------------


def test_remat_gives_identical_gradients(tiny):
    _, params, cfg, _ = tiny
    lat = [torch.from_numpy(x) for x in _latents(8)]
    d = _draws(9).port(True)
    grads = []
    for remat in (False, True):
        model = _port_model(params, cfg, remat=remat)
        _, _, ld = model(*lat, draws=d, camera_mask_ratio=torch.tensor(0.5),
                         object_mask_ratio=torch.tensor(0.5))
        ld["loss"].backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


# -- (j) the trainer on the CPU ---------------------------------------------


def _trainer(tiny, tiny_vae, tmp_path, **kw):
    _, params, cfg, _ = tiny
    model = _port_model(params, cfg, remat=True)
    return ttr.AMDTrainer(model, tiny_vae[2], ttr.TrainConfig(
        output_dir=str(tmp_path), mixed_precision="no", mu_dtype="bf16",
        camera_mask_ratio=0.5, object_mask_ratio=0.5, ema_decay=0.9,
        **kw))


def test_trainer_save_resume_continues_bit_equal(tiny, tiny_vae, tmp_path):
    batch = _pixel_batch(10)
    trainer = _trainer(tiny, tiny_vae, tmp_path, checkpoint_total_limit=1)
    for _ in range(2):
        assert np.isfinite(trainer.train_step(batch)["loss"])
    trainer.save()
    live = trainer.train_step(batch)
    live_params = {n: p.detach().clone()
                   for n, p in trainer.model.named_parameters()}
    live_ema = {n: e.clone() for n, e in trainer.state.ema_params.items()}

    resumed = _trainer(tiny, tiny_vae, tmp_path, resume=True,
                       checkpoint_total_limit=1)
    assert resumed.global_step == resumed.state.step == 2
    assert resumed.ckpt.latest_step() == 2
    again = resumed.train_step(batch)
    assert again == live
    for n, p in resumed.model.named_parameters():
        assert torch.equal(p, live_params[n]), n
        assert torch.equal(resumed.state.ema_params[n], live_ema[n]), n
    resumed.save()   # the limit of 1 keeps only the newest
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == \
        ["checkpoint-3"]


def test_trainer_nan_skip_drops_a_poisoned_step(tiny, tiny_vae, tmp_path):
    trainer = _trainer(tiny, tiny_vae, tmp_path, nan_policy="skip")
    batch = _pixel_batch(11)
    poisoned = dict(batch, videos=np.full_like(batch["videos"], np.nan))
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    m = trainer.train_step(poisoned)
    assert m["nan_skipped"] == 1.0 and not np.isfinite(m["loss"])
    assert trainer.state.step == 0 and trainer.global_step == 1
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, before[n]), n
    m = trainer.train_step(batch)
    assert m["nan_skipped"] == 0.0 and trainer.state.step == 1


def test_trainer_nan_halt_dumps_and_raises(tiny, tiny_vae, tmp_path):
    trainer = _trainer(tiny, tiny_vae, tmp_path, nan_policy="halt")
    batch = _pixel_batch(12)
    poisoned = dict(batch, videos=np.full_like(batch["videos"], np.nan))
    with pytest.raises(FloatingPointError, match="dumped"):
        trainer.fit(iter([poisoned]), max_steps=1)
    assert (tmp_path / "nan_batch_step1.npz").exists()


def test_trainer_rejects_low_precision_master_weights(tiny, tiny_vae,
                                                      tmp_path):
    _, params, cfg, _ = tiny
    model = _port_model(params, cfg).to(torch.bfloat16)
    with pytest.raises(ValueError, match="fp32 master"):
        ttr.AMDTrainer(model, tiny_vae[2],
                       ttr.TrainConfig(output_dir=str(tmp_path)))


def test_without_a_card_cuda_paths_raise():
    """Entry points default to CUDA and raise without a GPU; a kernel
    wrapper given a CPU tensor raises rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device()
    x = torch.zeros((1, 1, 300, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.full_block_attention_bwd(x, x, x, x, x, x, x, scale=0.125)
