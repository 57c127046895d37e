"""The label/text-to-motion head of the port (``models/t2m.py``,
``data/text.py``, ``LabelVideoDataset``) against the JAX package, fp32 on
the CPU, at a tiny ``T2MConfig`` (2 layers, 2 heads of 8):

  * the forward at N = 2, T = 3, int and float labels, with and without an
    object source, the flow noise replayed: every output within 1e-4 of
    the JAX module's (fp32, sums in another order). The two samples have
    different labels and timesteps, so the frame-major tile of the
    conditioning (row r takes sample r % N while the image, camera and
    object rows are batch-major) is pinned: a batch-major tile moves the
    velocities by O(1);
  * the loss and the gradient of every parameter (relative to the
    tensor's largest element, 1e-4);
  * ``sample`` in Euler and Heun, the JAX start noise replayed (1e-4);
  * the bridge: every JAX leaf maps onto the port's parameters, none
    missing or unexpected; the ``motion_dim != object_channel`` refusal on
    both sides;
  * ``TextEncoder``'s fallback and ``load_text_embedding`` bit for bit,
    and the pooled embedding as a float label;
  * ``LabelVideoDataset`` bit for bit (items, labels, classes) against
    the JAX dataset under the same seed.
"""

import jax
import numpy as np
import pytest
import torch

from hivae_tpu.data import datasets as jdata
from hivae_tpu.data import text as jtext
from hivae_tpu.models import t2m as jt2m
from hivae_tpu_torch.data import datasets as tdata
from hivae_tpu_torch.data import text as ttext
from hivae_tpu_torch.models import t2m as tt2m
from hivae_tpu_torch.utils.params import flax_to_torch
from test_torch_amd_family import _one_thread  # noqa: F401
from test_torch_amd_family_models import random_params
from test_torch_data import _frames, _write_mp4
from test_torch_training import _close_rel, _replay

KEY = jax.random.PRNGKey(0)
N, T = 2, 3
CFG = dict(label_dim=16, num_classes=5, motion_dim=8, refimg_height=8,
           refimg_width=8, refimg_dim=4, num_frames=T, time_embed_dim=32,
           attention_head_dim=8, num_attention_heads=2, num_layers=2,
           camera_token_num=3, object_token_num=4, camera_channel=6,
           object_channel=8)
TOL = 1e-4


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(cam=f(N, T, 3, 6), obj=f(N * T, 4, 8), src=f(N * T, 4, 8),
                ref=f(N, T, 4, 8, 8), noise=f(N * T, 4, 8),
                ts=np.array([100.0, 900.0], np.float32),
                label=np.array([1, 3], np.int32), text=f(N, 16))


@pytest.fixture(scope="module")
def heads():
    """(JAX module, params, the port's module on them)."""
    jmod = jt2m.Label2MotionDiffusionDecoder(cfg=jt2m.T2MConfig(**CFG))
    x = _inputs()
    params = random_params(jmod, x["cam"], x["obj"], x["label"], x["ref"],
                           x["ts"], object_source_motion=x["src"], seed=7)
    tmod = tt2m.Label2MotionDiffusionDecoder(tt2m.T2MConfig(**CFG),
                                             device="cpu")
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    return jmod, params, tmod


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _jax_forward(jmod, params, label, src):
    x = _inputs()
    return jax.jit(lambda p, lab, s: jmod.apply(
        p, x["cam"], x["obj"], lab, x["ref"], x["ts"],
        object_source_motion=s, noise=x["noise"]))(params, label, src)


def _port_forward(tmod, label, src):
    x = _inputs()
    return tmod(_t(x["cam"]), _t(x["obj"]), _t(label), _t(x["ref"]),
                _t(x["ts"]), object_source_motion=_t(src),
                noise=_t(x["noise"]))


@pytest.mark.parametrize("source", [False, True], ids=["plain", "source"])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_forward_matches_jax(heads, kind, source):
    jmod, params, tmod = heads
    x = _inputs()
    label = x["label"] if kind == "int" else x["text"]
    src = x["src"] if source else None
    want = _jax_forward(jmod, params, label, src)
    got = _port_forward(tmod, label, src)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=TOL, rtol=TOL)
    assert got["vel_pred_object"].shape == (N * T, 4, 8)
    assert got["vel_pred_camera"].shape == (N * T, 3, 6)


def test_tile_order_is_frame_major(heads):
    """Row r of the N*T rows takes sample r % N's label and timestep (the
    JAX package's ``jnp.tile``), while its image, camera and object inputs
    are sample r // T's: changing sample 1's label moves rows 1, 3 and 5
    and leaves rows 0, 2 and 4 as they were (a batch-major tile would move
    rows 3, 4 and 5), on both sides."""
    jmod, params, tmod = heads
    x = _inputs()
    lab = x["label"].copy()
    lab[1] = 0
    moved = [r % N == 1 for r in range(N * T)]
    assert moved != [r // T == 1 for r in range(N * T)]
    for fwd in (lambda l: np.asarray(_jax_forward(jmod, params, l, None)[
                    "vel_pred_object"]),
                lambda l: _port_forward(tmod, l, None)[
                    "vel_pred_object"].detach().numpy()):
        delta = np.abs(fwd(lab) - fwd(x["label"])).max(axis=(1, 2))
        assert list(delta > 1e-3) == moved, delta
        assert delta[~np.array(moved)].max() <= 1e-6


def test_loss_and_gradients_match_jax(heads):
    jmod, params, tmod = heads
    x = _inputs()

    def loss_fn(p):
        out = jmod.apply(p, x["cam"], x["obj"], x["label"], x["ref"],
                         x["ts"], noise=x["noise"])
        return jmod.loss(out)
    want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tmod.zero_grad()
    out = _port_forward(tmod, x["label"], None)
    loss = tmod.loss(out)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    jg = flax_to_torch(jax.device_get(jgrads))
    names = dict(tmod.named_parameters())
    assert jg.keys() == names.keys()
    unused = {n for n, p in names.items() if p.grad is None}
    # no object source, and the camera velocity is not in the loss
    assert unused == {"motion_align_o", "camera_proj_out.weight",
                      "camera_proj_out.bias"}
    for name, p in names.items():
        if name in unused:
            assert not np.any(jg[name].numpy()), name
            continue
        _close_rel(p.grad.numpy(), jg[name].numpy(), tol=TOL)


@pytest.mark.parametrize("solver", ["euler", "heun"])
def test_sample_matches_jax(heads, solver):
    jmod, params, tmod = heads
    x = _inputs()
    z0 = np.random.RandomState(9).randn(N * T, 4, 8).astype(np.float32)
    with _replay(normal=[z0]):
        want = jax.jit(lambda p: jt2m.sample(
            jmod, p, KEY, x["label"], x["ref"], x["cam"], sample_steps=3,
            solver=solver))(params)
    got = tt2m.sample(tmod, _t(x["label"]), _t(x["ref"]), _t(x["cam"]),
                      sample_steps=3, solver=solver, z0=_t(z0))
    assert got.shape == (N * T, 4, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_motion_dim_refused_on_both_sides():
    bad = dict(CFG, motion_dim=16)
    with pytest.raises(ValueError, match="must equal object_channel"):
        jt2m.Label2MotionDiffusionDecoder(cfg=jt2m.T2MConfig(**bad))
    with pytest.raises(ValueError, match="must equal object_channel"):
        tt2m.Label2MotionDiffusionDecoder(tt2m.T2MConfig(**bad),
                                          device="cpu")


def test_config_round_trip_matches_jax():
    want = jt2m.T2MConfig.from_dict(dict(CFG, extra=1)).to_dict()
    got = tt2m.T2MConfig.from_dict(dict(CFG, extra=1)).to_dict()
    assert got == want
    assert tt2m.T2MConfig().to_dict() == jt2m.T2MConfig().to_dict()


# -- text -------------------------------------------------------------------


def test_text_encoder_fallback_bit_equal(heads, tmp_path, monkeypatch):
    texts = ["a person waves", "A dog runs  fast", "", "waves"]
    for width in (16, 512):
        jseq, jpool = jtext.TextEncoder(width=width)(texts)
        tseq, tpool = ttext.TextEncoder(width=width)(texts)
        assert tseq.dtype == jseq.dtype and tpool.dtype == jpool.dtype
        assert np.array_equal(tseq, jseq) and np.array_equal(tpool, jpool)
    assert tseq.shape == (4, 77, 512)
    # a checkpoint that transformers cannot load is an error, not hashed
    # stand-in embeddings (a stand-in module: importing transformers itself
    # takes seconds)
    import types

    def unavailable(path):
        raise OSError(f"no CLIP at {path}")
    stub = types.ModuleType("transformers")
    stub.CLIPTokenizer = stub.CLIPTextModel = types.SimpleNamespace(
        from_pretrained=unavailable)
    monkeypatch.setitem(__import__("sys").modules, "transformers", stub)
    with pytest.raises(RuntimeError, match="no_clip"):
        ttext.TextEncoder(model_path=str(tmp_path / "no_clip"), width=16,
                          device="cpu")
    np.save(tmp_path / "e.npy", tpool.astype(np.float64))
    assert np.array_equal(ttext.load_text_embedding(str(tmp_path / "e.npy")),
                          jtext.load_text_embedding(str(tmp_path / "e.npy")))
    # the pooled text embedding conditions the head as a float label
    jmod, params, tmod = heads
    pooled = ttext.TextEncoder(width=16)(texts[:2])[1]
    want = _jax_forward(jmod, params, pooled, None)["vel_pred_object"]
    got = _port_forward(tmod, pooled, None)["vel_pred_object"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


# -- the dataset ------------------------------------------------------------


@pytest.fixture(scope="module")
def label_tree(tmp_path_factory):
    """Two class directories (UCF-101's layout) of mp4s."""
    d = tmp_path_factory.mktemp("label_tree")
    for i, (cls, frames) in enumerate((("clsA", 12), ("clsA", 9),
                                       ("clsB", 10))):
        (d / cls).mkdir(exist_ok=True)
        _write_mp4(d / cls / f"v{i}.mp4", _frames(i, frames=frames, size=24))
    return str(d)


@pytest.mark.parametrize("classes", [None, ["clsB", "clsA"]])
def test_label_dataset_bit_equal(label_tree, classes):
    kw = dict(sample_n_frames=T, sample_size=16, seed=5, use_grey=True,
              classes=classes)
    jds = jdata.LabelVideoDataset(label_tree, **kw)
    tds = tdata.LabelVideoDataset(label_tree, **kw)
    assert tds.classes == jds.classes and len(tds) == len(jds) == 3
    assert tds.class_to_idx == jds.class_to_idx
    for _ in range(2):
        for i in range(len(jds)):
            want, got = jds[i], tds[i]
            assert got.keys() == want.keys()
            for k in got:
                if k == "name":
                    assert got[k] == want[k]
                    continue
                assert got[k].dtype == want[k].dtype, k
                assert np.array_equal(got[k], want[k]), (i, k)
    labels = sorted(int(tds[i]["label"]) for i in range(3))
    assert labels == ([0, 0, 1] if classes is None else [0, 1, 1])
