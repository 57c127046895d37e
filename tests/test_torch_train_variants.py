"""The ``AMDConfig`` flags of ``AMDModelNew`` beyond the flagship, and the
remat policies, against the JAX package on the CPU at the tiny flagship
size (``__graft_entry__._flagship(tiny=True)``), fp32:

  * ``use_mask`` with ``use_camera_down`` and ``need_motion_transformer``
    (and ``use_regularizers``, which ``AMDModelNew`` accepts and does not
    read), one model: the optical-flow camera mask on the low band, the
    camera encoder on a 4x smaller grid, the motion transformer in
    ``extract_motion`` and ``sample_with_refimg_motion``, with and without
    ``extract_motion_with_motion_transformer``;
  * ``diffusion_model_type="default"``: ``VelocityDiTTempMotion`` with one
    timestep per frame; its ``scan_layers`` stack maps onto the same state
    dict as the unrolled layers.

Each variant's JAX parameter tree loads into the port with
``strict=True``; its training forward (loss 2e-4 relative; gradients
within 2e-4 of each tensor's largest element, as ``test_torch_models.py``
holds them) runs on the numpy draws replayed into ``jax.random``, and one
``sample`` runs on the JAX draws replayed through ``SampleDraws``
(latents within ``test_torch_serving.TOL``).

The remat policies are held against the port's run without remat (loss
1e-6 relative, gradients 1e-5 relative and 1e-6 absolute, as
``tests/test_remat_policy.py`` holds the JAX side), and each is shown to
keep what it says: the bytes a step keeps for its backward fall from no
remat over ``dots`` and ``dots_sans_ffn`` to ``full``, and ``dots_offload``
keeps ``dots``' matmul outputs in host memory."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from hivae_tpu.models import amd as jamd
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import dit as tdit
from hivae_tpu_torch.utils.params import flax_to_torch
from test_torch_serving import TOL, recorded_draws
from test_torch_training import _close_rel, _perturb, _replay

KEY = jax.random.PRNGKey(0)
N, T, LAT = 1, 4, 16
BASE = graft._flagship(tiny=True, frames=T).cfg

VARIANTS = {
    "mask_camera_down_motion_transformer": dict(
        use_mask=True, use_regularizers=True, use_camera_down=True,
        need_motion_transformer=True),
    "default_dit": dict(diffusion_model_type="default"),
}
MASKED = "mask_camera_down_motion_transformer"
_MODELS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these tiny models gain nothing from more, and
    the suite runs several test processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _camera_mask(seed):
    """A {0, 1} latent-resolution mask (N, 2T, 4, LAT, LAT), one pattern
    tiled as the dataset tiles it."""
    m = (np.random.RandomState(seed).rand(LAT, LAT) > 0.4).astype(np.float32)
    return np.ascontiguousarray(np.broadcast_to(m, (N, 2 * T, 4, LAT, LAT)))


def variant(name):
    """(JAX module, perturbed params, port module) of a variant, built
    once a module."""
    if name not in _MODELS:
        cfg = BASE.replace(**VARIANTS[name])
        jmod = jamd.AMDModelNew(cfg=cfg)
        v = jnp.zeros((N, T, 4, LAT, LAT))
        kw = dict(camera_mask=jnp.ones((N, 2 * T, 4, LAT, LAT))) \
            if cfg.use_mask else {}
        params = _perturb(jax.device_get(jax.jit(
            lambda: jmod.init({"params": KEY, "noise": KEY}, v, v, v, v,
                              **kw))()), seed=3)
        tmod = tamd.AMDModelNew(tamd.AMDConfig.from_dict(cfg.to_dict()),
                                device="cpu")
        tmod.load_state_dict(flax_to_torch(params), strict=True)
        _MODELS[name] = (jmod, params, tmod)
    return _MODELS[name]


def _latents(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(N, T, 4, LAT, LAT).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_training_forward_loss_and_grads_match_jax(name):
    jmod, params, tmod = variant(name)
    cfg = tmod.cfg
    lat = _latents(1)
    rng = np.random.RandomState(2)
    per_frame = cfg.diffusion_model_type == "default"
    ts = rng.randint(0, 1001, (N * T,) if per_frame else (N,)).astype(
        np.int32)
    z0 = rng.randn(N * T, 4, LAT, LAT).astype(np.float32)
    kw = dict(camera_mask=_camera_mask(4)) if cfg.use_mask else {}

    def loss_fn(p):
        _, _, ld = jmod.apply(p, *lat, rngs={"noise": KEY},
                              **{k: jnp.asarray(v) for k, v in kw.items()})
        return ld["loss"], ld
    with _replay(randint=[ts], normal=[z0]):
        (_, jld), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)

    tmod.zero_grad()
    draws = tamd.TrainDraws(
        time_step=torch.from_numpy(ts if per_frame else np.repeat(ts, T)),
        z0=torch.from_numpy(z0))
    _, _, ld = tmod(*map(torch.from_numpy, lat), draws=draws,
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    ld["loss"].backward()
    for k in ("loss", "diff_loss", "rec_loss"):
        np.testing.assert_allclose(ld[k].item(), float(jld[k]), rtol=2e-4)
    want = flax_to_torch(jax.device_get(jgrads))
    got = dict(tmod.named_parameters())
    assert set(got) == set(want)
    for pname, p in got.items():
        g = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        _close_rel(g, want[pname].numpy(), tol=2e-4)


@pytest.mark.parametrize("name,camera_mask_ratio", [(MASKED, 0.5),
                                                    ("default_dit", None)])
def test_sample_matches_jax(monkeypatch, name, camera_mask_ratio):
    jmod, params, tmod = variant(name)
    video, ref, grey, gref = _latents(5)
    kw = dict(camera_mask=_camera_mask(6)) if tmod.cfg.use_mask else {}
    with recorded_draws(monkeypatch) as draws:
        want = jamd.sample_jit(jmod, params, jax.random.PRNGKey(3),
                               *map(jnp.asarray, (video, ref, grey, gref)),
                               sample_step=2,
                               camera_mask_ratio=camera_mask_ratio,
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    assert len(draws) == 1 + (camera_mask_ratio is not None)
    got = tamd.sample(tmod, *map(torch.from_numpy, (video, ref, grey, gref)),
                      sample_step=2, camera_mask_ratio=camera_mask_ratio,
                      generator=tamd.SampleDraws(replay=draws),
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_scan_layers_stack_loads_as_the_unrolled_layers():
    """The TempMotion DiT's ``scan_layers`` tree (``layers/object_block``,
    leading dim L) maps onto the state dict of its unrolled layers."""
    jmod, params, tmod = variant("default_dit")
    scanned = jamd.AMDModelNew(cfg=jmod.cfg.replace(scan_layers=True))
    v = jnp.zeros((N, T, 4, LAT, LAT))
    shapes = jax.eval_shape(lambda: scanned.init(
        {"params": KEY, "noise": KEY}, v, v, v, v))
    dit = dict(params["params"]["diffusion_transformer"])
    layers = [dit.pop(f"object_blocks_{i}")
              for i in range(jmod.cfg.diffusion_num_layers)]
    dit["layers"] = {"object_block": jax.tree.map(
        lambda *xs: np.stack(xs), *layers)}
    tree = dict(params["params"], diffusion_transformer=dit)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(
        lambda x: x.shape, shapes["params"])
    port = tamd.AMDModelNew(tamd.AMDConfig.from_dict(
        scanned.cfg.to_dict()), device="cpu")
    port.load_state_dict(flax_to_torch(tree), strict=True)
    for k, x in tmod.state_dict().items():
        assert torch.equal(port.state_dict()[k], x), k


def test_use_mask_reads_the_mask_and_needs_it():
    _, _, tmod = variant(MASKED)
    lat = [torch.from_numpy(x) for x in _latents(7)]
    with torch.no_grad():
        enc = [tmod.encode(*lat, camera_mask=torch.from_numpy(m))[0]
               for m in (_camera_mask(8), _camera_mask(9))]
    assert not torch.allclose(enc[0], enc[1])
    with pytest.raises(ValueError, match="camera_mask"):
        tmod(*lat)
    no_filter = tamd.AMDModelNew(tmod.cfg.replace(use_filter=False),
                                 device="cpu")
    with pytest.raises(ValueError, match="use_filter"):
        no_filter.encode(*lat, camera_mask=torch.from_numpy(_camera_mask(8)))


def _with_extract_flag(flag):
    jmod, params, tmod = variant(MASKED)
    if not flag:
        return jmod, params, tmod
    cfg = jmod.cfg.replace(extract_motion_with_motion_transformer=True)
    port = tamd.AMDModelNew(tamd.AMDConfig.from_dict(cfg.to_dict()),
                            device="cpu")
    port.load_state_dict(tmod.state_dict(), strict=True)
    return jamd.AMDModelNew(cfg=cfg), params, port


@pytest.mark.parametrize("with_transformer", [False, True])
def test_motion_transformer_paths_match_jax(monkeypatch, with_transformer):
    """``extract_motion`` runs the motion transformer only with
    ``extract_motion_with_motion_transformer``; refimg-motion sampling
    then takes the given target motion as it is, and otherwise runs it
    through the transformer."""
    jmod, params, tmod = _with_extract_flag(with_transformer)
    rng = np.random.RandomState(10)
    video = rng.randn(N, T, 4, LAT, LAT).astype(np.float32)
    want = jamd.extract_motion_jit(jmod, params, jnp.asarray(video))
    got = tamd.extract_motion(tmod, torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    ref_img = rng.randn(N, 4, LAT, LAT).astype(np.float32)
    motion = rng.randn(N, T, 4, 32).astype(np.float32)
    with recorded_draws(monkeypatch) as draws:
        want = jamd.sample_with_refimg_motion_jit(
            jmod, params, jax.random.PRNGKey(6), jnp.asarray(ref_img),
            jnp.asarray(motion), sample_step=2)
    got = tamd.sample_with_refimg_motion(
        tmod, torch.from_numpy(ref_img), torch.from_numpy(motion),
        sample_step=2, generator=tamd.SampleDraws(replay=draws))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# -- remat policies ----------------------------------------------------------


def _remat_loss_and_grads(policy):
    """Loss and gradients of the training forward of the tiny flagship on
    seeded port weights, with ``policy`` (None: no remat)."""
    torch.manual_seed(0)
    cfg = tamd.AMDConfig.from_dict(BASE.to_dict())
    cfg = cfg.replace(remat=policy is not None,
                      remat_policy=policy or "full")
    model = tamd.AMDModelNew(cfg, device="cpu")
    lat = [torch.from_numpy(x) for x in _latents(11)]
    rng = np.random.RandomState(12)
    draws = tamd.TrainDraws(
        time_step=torch.from_numpy(np.repeat(rng.randint(0, 1001, (N,)), T)),
        z0=torch.from_numpy(rng.randn(N * T, 4, LAT, LAT).astype(
            np.float32)))
    _, _, ld = model(*lat, draws=draws)
    ld["loss"].backward()
    return ld["loss"].item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def no_remat():
    return _remat_loss_and_grads(None)


@pytest.mark.parametrize("policy", ["full", "dots", "dots_sans_ffn",
                                    "dots_offload"])
def test_remat_policy_matches_no_remat(no_remat, policy):
    l0, g0 = no_remat
    l1, g1 = _remat_loss_and_grads(policy)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert set(g1) == set(g0)
    for name, g in g0.items():
        np.testing.assert_allclose(g1[name].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _tensors(obj):
    """The tensors held in a caching mode's storage (nested dicts and
    lists of tensors, or of wrappers holding one as ``val``)."""
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
        return
    x = getattr(obj, "val", obj)
    if torch.is_tensor(x):
        yield x


class _SavedBytes:
    """Counts the bytes a forward keeps for its backward: what autograd
    saves outside the checkpointed layers (saved-tensor hooks; parameters
    excluded) plus what each layer's policy keeps (the caching modes the
    layers' ``context_fn`` returns), and the devices of the latter."""

    def __init__(self, monkeypatch):
        self.modes, self.outer, self.params = [], {}, set()
        for name, fn in list(tdit._CONTEXT_FNS.items()):
            def wrapped(fn=fn):
                fwd, rec = fn()
                self.modes.append(fwd)
                return fwd, rec
            monkeypatch.setitem(tdit._CONTEXT_FNS, name, wrapped)

    def _pack(self, x):
        key = x.untyped_storage().data_ptr()
        if key not in self.params:
            self.outer[key] = x.untyped_storage().nbytes()
        return x

    def __enter__(self):
        self.hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda x: x)
        self.hooks.__enter__()
        return self

    def __exit__(self, *exc):
        return self.hooks.__exit__(*exc)

    def kept(self):
        return [x for mode in self.modes for x in _tensors(mode.storage)]

    def total(self):
        return sum(self.outer.values()) + sum(
            x.untyped_storage().nbytes() for x in self.kept())


def test_remat_policies_keep_what_they_say(monkeypatch):
    counts = {}
    for policy in (None, "dots", "dots_sans_ffn", "full", "dots_offload"):
        saved = _SavedBytes(monkeypatch)
        torch.manual_seed(0)
        model = tamd.AMDModelNew(tamd.AMDConfig.from_dict(BASE.to_dict())
                                 .replace(remat=policy is not None,
                                          remat_policy=policy or "full"),
                                 device="cpu")
        saved.params = {p.untyped_storage().data_ptr()
                        for p in model.parameters()}
        lat = [torch.from_numpy(x) for x in _latents(13)]
        with saved:
            _, _, ld = model(*lat)
        counts[policy] = saved.total()
        if policy in ("dots", "dots_sans_ffn", "dots_offload"):
            kept = saved.kept()
            assert kept and all(x.device.type == "cpu" for x in kept)
        if policy == "dots_offload":
            # the same matmul outputs as dots, one copy each
            assert len(kept) == n_dots
        if policy == "dots":
            n_dots = len(saved.kept())
        ld["loss"].backward()
    assert counts[None] > counts["dots"] > counts["dots_sans_ffn"] > \
        counts["full"], counts


def test_unknown_remat_policy_is_refused():
    with pytest.raises(ValueError, match="remat_policy"):
        tamd.AMDModelNew(dataclasses.replace(
            tamd.AMDConfig.from_dict(BASE.to_dict()), remat=True,
            remat_policy="dots_everything"), device="cpu")
