"""The dual-encoder ``AMDModel`` and ``AMDModelRec`` of the port
(``models/amd.py``) against the JAX package's, fp32 on the CPU, at the
tiny widths of ``test_torch_amd_family.TINY`` (one encoder layer): the
training forward, its losses (``KLloss`` under ``use_regularizers``) and
gradients for both motion types, all three DiT types, with and without
the KL bottleneck, both encoder kinds, the motion transformer and the
camera mask; ``encode`` with a float mask ratio and
``encode_diff_motion``; ``AMDModelRec`` in both forms.

Parameters come from ``jax.eval_shape`` of the flax init filled from a
numpy seed (``random_params``), load into the port with ``strict=True``,
and the draws (timesteps, flow noise, KL posterior noises, mask
uniforms) are replayed on both sides. Losses within 2e-4 relative,
outputs within ``test_torch_models.TOL``, gradients within 2e-4 of each
tensor's largest element and by cosine >= 0.9999 over the whole
gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hivae_tpu.models import amd as jamd
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.utils.params import flax_to_torch
from test_torch_amd_family import (LAT, N, T, TINY, _one_thread,
                                   _t, mask_draws)
from test_torch_models import KEY, _close
from test_torch_training import _close_rel, _replay

GRAD_COS = 0.9999

# -- AMDModel ------------------------------------------------------------------

# (name, config flags): both motion types and the three DiTs, with and
# without the KL bottleneck, both encoder kinds (the spatial pair with
# camera_down), the motion transformer and the camera mask
MODELS = {
    "default_plus_kl": dict(use_filter=True, use_grey=True,
                            diffusion_model_type="default",
                            motion_type="plus", use_regularizers=True),
    "default_decouple": dict(use_filter=True, diffusion_model_type="default",
                             motion_type="decouple"),
    "spatial_plus": dict(use_filter=True, use_grey=True,
                         diffusion_model_type="spatial", motion_type="plus"),
    "spatial_decouple_kl_down": dict(
        use_filter=True, use_grey=True, diffusion_model_type="spatial",
        motion_type="decouple", use_regularizers=True,
        use_motiontemporal=False, use_camera_down=True),
    "dual_kl_motion_transformer": dict(
        use_filter=True, diffusion_model_type="dual",
        use_regularizers=True, need_motion_transformer=True),
    "default_mask_no_filter_down": dict(
        use_filter=True, use_mask=True, diffusion_model_type="default",
        motion_type="plus", use_motiontemporal=False, use_camera_down=True),
}
_BUILT = {}


def random_params(jmod, *args, seed=3, **kw):
    """A parameter tree of ``jmod`` from ``jax.eval_shape`` of its init
    (no compilation), filled from a numpy seed: kernels at 1/sqrt(fan-in),
    norm scales 1 + N(0, 0.05), every other leaf N(0, 0.05)."""
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": KEY, "noise": KEY, "noise_kl": KEY}, *args, **kw))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        x = rng.randn(*leaf.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.05 * x
        return 0.05 * x
    return jax.tree_util.tree_map_with_path(fill, shapes)


def model(name):
    """(flax module, params, port module) of a tiny AMDModel, built once a
    module."""
    if name not in _BUILT:
        cfg = jamd.AMDConfig(**TINY, **MODELS[name])
        jmod = jamd.AMDModel(cfg=cfg)
        v = jnp.zeros((N, T, 4, LAT, LAT))
        kw = dict(camera_mask=jnp.ones((N, 2 * T, 4, LAT, LAT))) \
            if cfg.use_mask else {}
        params = random_params(jmod, v, v, v, v, **kw)
        tmod = tamd.AMDModel(tamd.AMDConfig.from_dict(cfg.to_dict()),
                             device="cpu")
        tmod.load_state_dict(flax_to_torch(params), strict=True)
        _BUILT[name] = (jmod, params, tmod)
    return _BUILT[name]


def latents(seed, n=N):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, T, 4, LAT, LAT).astype(np.float32)
            for _ in range(4)]


def camera_mask(seed):
    m = (np.random.RandomState(seed).rand(LAT, LAT) > 0.4).astype(np.float32)
    return np.ascontiguousarray(np.broadcast_to(m, (N, 2 * T, 4, LAT, LAT)))


def kl_draws(tmod, seed):
    """The (object, camera) posterior noises, channels first."""
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in tmod.kl_shapes(N, T)]


def _cosine(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_amd_model_forward_loss_and_grads_match_jax(name):
    jmod, params, tmod = model(name)
    cfg = tmod.cfg
    lat = latents(1)
    rng = np.random.RandomState(2)
    per_frame = cfg.diffusion_model_type == "default"
    ts = rng.randint(0, 1001, (N * T,) if per_frame else (N,)).astype(
        np.int32)
    z0 = rng.randn(N * T, 4, LAT, LAT).astype(np.float32)
    kl = kl_draws(tmod, 3) if cfg.use_regularizers else []
    kw = dict(camera_mask=camera_mask(4)) if cfg.use_mask else {}

    def loss_fn(p):
        _, _, ld = jmod.apply(p, *map(jnp.asarray, lat),
                              rngs={"noise": KEY, "noise_kl": KEY},
                              **{k: jnp.asarray(v) for k, v in kw.items()})
        return ld["loss"], ld
    with _replay(randint=[ts], normal=kl + [z0]):
        (_, jld), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)

    tmod.zero_grad()
    draws = tamd.TrainDraws(
        time_step=_t(ts if per_frame else np.repeat(ts, T)), z0=_t(z0),
        object_kl=_t(kl[0]) if kl else None,
        camera_kl=_t(kl[1]) if kl else None)
    _, _, ld = tmod(*map(_t, lat), draws=draws,
                    **{k: _t(v) for k, v in kw.items()})
    ld["loss"].backward()
    keys = ("loss", "diff_loss", "rec_loss") + \
        (("KLloss",) if cfg.use_regularizers else ())
    assert set(ld) == set(keys) == set(jld)
    for k in keys:
        np.testing.assert_allclose(ld[k].item(), float(jld[k]), rtol=2e-4)
    want = flax_to_torch(jax.device_get(jgrads))
    got = dict(tmod.named_parameters())
    assert set(got) == set(want)
    flat_g, flat_w = [], []
    for pname, p in got.items():
        g = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        _close_rel(g, want[pname].numpy(), tol=2e-4)
        flat_g.append(g.ravel())
        flat_w.append(want[pname].numpy().ravel())
    assert _cosine(np.concatenate(flat_g), np.concatenate(flat_w)) >= \
        GRAD_COS


def test_amd_model_encode_and_diff_motion_match_jax(mask_draws):
    """``encode`` with a float ratio (both encoders masked, the JAX
    package's uniforms given to the port) and ``encode_diff_motion``; the
    KL posterior noises replayed into ``jax.random.normal``."""
    jmod, params, tmod = model("spatial_decouple_kl_down")
    video, ref, grey, gref = latents(5)
    cam = latents(6)[0]
    kl = kl_draws(tmod, 7)
    with _replay(normal=list(kl)):
        want = jmod.apply(params, *map(jnp.asarray, (video, ref, grey,
                                                      gref)), 0.5,
                          method="encode",
                          rngs={"mask": jax.random.PRNGKey(4),
                                "noise_kl": KEY})
    uo, uc = mask_draws      # the object encoder draws first
    assert uo.shape[1] == tmod.encoder_sites(_t(video))[0]
    got = tmod.encode(*map(_t, (video, ref, grey, gref)), 0.5,
                      object_u=_t(uo), camera_u=_t(uc), object_kl=_t(kl[0]),
                      camera_kl=_t(kl[1]))
    for k in ("camera_source", "camera_target", "object_source",
              "object_target"):
        _close(got[k].detach(), want[k])
    np.testing.assert_allclose(got["kl_loss"].item(), float(want["kl_loss"]),
                               rtol=2e-4)
    with _replay(normal=list(kl)):
        want = jmod.apply(params, *map(jnp.asarray, (video, ref, grey, gref,
                                                      cam)),
                          method="encode_diff_motion",
                          rngs={"noise_kl": KEY})
    got = tmod.encode_diff_motion(*map(_t, (video, ref, grey, gref, cam)),
                                  object_kl=_t(kl[0]), camera_kl=_t(kl[1]))
    for k in ("camera_source", "camera_target", "object_source",
              "object_target"):
        _close(got[k].detach(), want[k])


@pytest.mark.parametrize("split", [False, True])
def test_amd_model_rec_forward_loss_and_grads_match_jax(split):
    cfg = jamd.AMDConfig(**TINY)
    jmod = jamd.AMDModelRec(cfg=cfg, is_split=split)
    video, ref = latents(8)[:2]
    params = random_params(jmod, jnp.asarray(video), jnp.asarray(ref),
                           seed=9)
    tmod = tamd.AMDModelRec(tamd.AMDConfig.from_dict(cfg.to_dict()),
                            is_split=split, device="cpu")
    tmod.load_state_dict(flax_to_torch(params), strict=True)

    def loss_fn(p):
        pre, ld = jmod.apply(p, jnp.asarray(video), jnp.asarray(ref))
        return ld["loss"], pre
    (jloss, jpre), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    pre, ld = tmod(_t(video), _t(ref))
    ld["loss"].backward()
    _close(pre.detach(), jpre)
    np.testing.assert_allclose(ld["rec_loss"].item(), float(jloss),
                               rtol=2e-4)
    want = flax_to_torch(jax.device_get(jgrads))
    for pname, p in tmod.named_parameters():
        _close_rel(p.grad.numpy(), want[pname].numpy(), tol=2e-4)
