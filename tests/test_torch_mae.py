"""The masked autoencoder of the port (``models/mae.py``) against the JAX
package, fp32 on the CPU, at a tiny ``MaskedAutoencoderViT`` (8 x 8
latents in 2 x 2 patches, 2 encoder and 1 decoder blocks):

  * the training forward with the JAX masking draw replayed: the mask
    bit for bit, the loss within 1e-5 relative and the prediction within
    1e-5 (fp32), with ``norm_pix_loss`` off and on, at mask ratios 0.75
    and 0.5;
  * the gradient of every parameter (relative to the tensor's largest
    element, 1e-4);
  * ``patchify``/``unpatchify`` bit for bit (both directions, a
    non-square grid too) and ``reconstruct`` (mask ratio 0) within 1e-5;
  * the bridge: every JAX leaf maps onto the port's parameters, none
    missing or unexpected;
  * ``MAE_S`` and ``MAE_L`` at full width, counted on both sides without
    compiling (``jax.eval_shape`` against a ``meta`` module): 110.7 M and
    328.1 M parameters, every JAX leaf's name and layout landing on the
    port's parameter of that shape.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivae_tpu.models import mae as jmae
from hivae_tpu_torch.models import mae as tmae
from hivae_tpu_torch.utils import params as tparams
from hivae_tpu_torch.utils.params import flax_to_torch
from test_torch_amd_family import _one_thread  # noqa: F401
from test_torch_training import _close_rel, _replay

KEY = jax.random.PRNGKey(0)
N = 2
TINY = dict(img_size=(8, 8), patch_size=2, embed_dim=32, depth=2,
            num_heads=2, decoder_embed_dim=16, decoder_depth=1,
            decoder_num_heads=2)
TOL = 1e-5


def _imgs(seed=0):
    return np.random.RandomState(seed).randn(N, 4, 8, 8).astype(np.float32)


_BUILT = {}


def _models(norm_pix):
    """(JAX module, params, the port's module on them), once a module."""
    if norm_pix not in _BUILT:
        jmod = jmae.MaskedAutoencoderViT(norm_pix_loss=norm_pix, **TINY)
        shapes = jax.eval_shape(lambda: jmod.init(
            {"params": KEY, "mask": KEY}, _imgs()))
        rng = np.random.RandomState(4)
        params = jax.tree.map(lambda s: (0.3 * rng.randn(*s.shape)).astype(
            np.float32), shapes)
        tmod = tmae.MaskedAutoencoderViT(norm_pix_loss=norm_pix,
                                         device="cpu", **TINY)
        tmod.load_state_dict(flax_to_torch(params), strict=True)
        _BUILT[norm_pix] = jmod, params, tmod
    return _BUILT[norm_pix]


def _noise(seed):
    return np.random.RandomState(seed).rand(N, 16).astype(np.float32)


@pytest.mark.parametrize("ratio", [0.75, 0.5])
@pytest.mark.parametrize("norm_pix", [False, True], ids=["mse", "norm_pix"])
def test_forward_matches_jax(norm_pix, ratio):
    jmod, params, tmod = _models(norm_pix)
    noise = _noise(int(ratio * 8))
    with _replay(uniform=[noise]):
        want = jax.jit(lambda p: jmod.apply(p, _imgs(), ratio,
                                            rngs={"mask": KEY}))(params)
    got = tmod(torch.from_numpy(_imgs()), ratio,
               noise=torch.from_numpy(noise))
    loss, pred, mask = (x.detach().numpy() for x in got)
    assert np.array_equal(mask, np.asarray(want[2]))
    assert mask.sum() == N * (16 - int(16 * (1 - ratio)))
    np.testing.assert_allclose(loss, float(want[0]), rtol=TOL)
    np.testing.assert_allclose(pred, np.asarray(want[1]), atol=TOL, rtol=TOL)
    assert pred.shape == (N, 16, 16)


def test_gradients_match_jax():
    jmod, params, tmod = _models(True)
    noise = _noise(3)

    def loss_fn(p):
        with _replay(uniform=[noise]):
            return jmod.apply(p, _imgs(), 0.75, rngs={"mask": KEY})[0]
    want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tmod.zero_grad()
    loss = tmod(torch.from_numpy(_imgs()), 0.75,
                noise=torch.from_numpy(noise))[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=TOL)
    jg = flax_to_torch(jax.device_get(jgrads))
    names = dict(tmod.named_parameters())
    assert jg.keys() == names.keys()
    for name, p in names.items():
        _close_rel(p.grad.numpy(), jg[name].numpy(), tol=1e-4)


def test_patchify_and_reconstruct_match_jax():
    jmod, params, tmod = _models(False)
    x = _imgs(1)
    want = np.asarray(jmod.patchify(jnp.asarray(x)))
    got = tmod.patchify(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tmod.unpatchify(torch.from_numpy(got)).numpy(), x)
    assert np.array_equal(tmod.unpatchify(torch.from_numpy(want.copy())).numpy(),
                          np.asarray(jmod.unpatchify(jnp.asarray(want))))
    # a non-square grid: 4 x 8 latents in 2 x 2 patches
    wide = dict(TINY, img_size=(4, 8))
    jw = jmae.MaskedAutoencoderViT(**wide)
    tw = tmae.MaskedAutoencoderViT(device="meta", **wide)
    y = np.random.RandomState(2).randn(N, 4, 4, 8).astype(np.float32)
    py = tw.patchify(torch.from_numpy(y))
    assert np.array_equal(py.numpy(), np.asarray(jw.patchify(jnp.asarray(y))))
    assert np.array_equal(tw.unpatchify(py).numpy(),
                          np.asarray(jw.unpatchify(jnp.asarray(py.numpy()))))
    # reconstruct: mask ratio 0 (the JAX draw replayed: any order of the
    # kept patches gives the same round trip up to rounding)
    with _replay(uniform=[_noise(5)]):
        jrec = jax.jit(lambda p: jmod.apply(p, jnp.asarray(x),
                                            method="reconstruct",
                                            rngs={"mask": KEY}))(params)
    trec = tmod.reconstruct(torch.from_numpy(x)).detach().numpy()
    assert trec.shape == x.shape
    np.testing.assert_allclose(trec, np.asarray(jrec), atol=TOL, rtol=TOL)


def _shape_map(variables):
    """{port name: torch-layout shape} of a JAX shape tree, through the
    bridge's names and layouts (zero-stride views: nothing allocated)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables["params"]):
        names = tuple(str(p.key) for p in path)
        view = np.broadcast_to(np.float32(0), leaf.shape)
        out[tparams.flax_path_to_torch_key(names)] = tuple(
            tparams._torch_layout(names[-1], view).shape)
    return out


@pytest.mark.parametrize("name,count", [("MAE_S", 110_692_368),
                                        ("MAE_L", 328_083_472)])
def test_full_width_counts_match_jax(name, count):
    jmod = jmae.MAE_MODELS[name]()
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": KEY, "mask": KEY}, jnp.zeros((1, 4, 32, 32))))
    assert sum(math.prod(s.shape) for s in jax.tree.leaves(shapes)) == count
    tmod = tmae.MAE_MODELS[name](device="meta")
    assert sum(p.numel() for p in tmod.parameters()) == count
    assert _shape_map(shapes) == {k: tuple(p.shape)
                                  for k, p in tmod.named_parameters()}
    heads = {"MAE_S": 12, "MAE_L": 16}[name]
    assert tmod.transformer_blocks[0].attn.heads == heads
    assert tmod.decoder_blocks[0].attn.heads == 16
