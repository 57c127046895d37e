"""The fused qk-norm attention's plain version
(``full_block_attention_qknorm_plain``) against the JAX package's
``flash_attention(qk_norm=...)`` (its ``_fwd_kernel_qknorm`` in interpret
mode on the CPU, and the gradient of its custom VJP), and ``sdpa`` with
``QKNORM_FUSE`` on and off. The CUDA kernel itself is held against the plain
version on the card by ``tests/test_torch_cuda.py``.

Tolerance: fp32 on both sides; the LayerNorm statistics and the attention
sums are taken in another order (atol 1e-4 on unit-scale outputs; gradients
within 1e-4 of their largest element)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivae_tpu.ops.pallas import flash_attention as jfa
from hivae_tpu_torch.ops import attention as tattn
from hivae_tpu_torch.ops.kernels import flash_attention as tfa

ATOL = 1e-4
GRAD_RTOL = 1e-4


def _inputs(shape, seed):
    """Raw q, k far from normalised, v, and gamma/beta away from (1, 0)."""
    rng = np.random.RandomState(seed)
    q = (3 * rng.randn(*shape) + 1).astype(np.float32)
    k = (2 * rng.randn(*shape) - 1).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    d = shape[3]
    norms = [(1 + 0.5 * rng.randn(d)).astype(np.float32),
             (0.3 * rng.randn(d)).astype(np.float32),
             (1 + 0.5 * rng.randn(d)).astype(np.float32),
             (0.3 * rng.randn(d)).astype(np.float32)]
    return q, k, v, norms


def _mask_bias(b, s, seed):
    keep = np.random.RandomState(seed).rand(b, s) > 0.3
    keep[:, 0] = True   # no fully masked row (see test_torch_kernels.py)
    return np.where(keep, 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("s,masked", [(260, False), (266, True)])
def test_qknorm_plain_matches_pallas(s, masked):
    q, k, v, norms = _inputs((2, 2, s, 64), seed=s)
    bias = _mask_bias(2, s, seed=1) if masked else None
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.125,
        bias=None if bias is None else jnp.asarray(bias),
        qk_norm=tuple(map(jnp.asarray, norms))))
    got = tfa.full_block_attention_qknorm(
        *map(torch.from_numpy, (q, k, v, *norms)), scale=0.125,
        bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert tfa.full_block_attention_qknorm.launches == 0


def test_qknorm_plain_gradients_match_jax():
    """Gradients for q, k, v and the four norm parameters: the JAX
    package's custom VJP (the unfused composition's gradient) against
    autograd through the port's plain version."""
    q, k, v, norms = _inputs((1, 2, 260, 64), seed=3)
    do = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    args = [jnp.asarray(x) for x in (q, k, v, *norms)]

    def f(q, k, v, gq, bq, gk, bk):
        return jfa.flash_attention(q, k, v, scale=0.125,
                                   qk_norm=(gq, bq, gk, bk))

    _, vjp = jax.vjp(f, *args)
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, *norms)]
    tfa.full_block_attention_qknorm(*leaves, scale=0.125).backward(
        torch.from_numpy(do))
    for name, leaf, w in zip(["q", "k", "v", "gq", "bq", "gk", "bk"], leaves,
                             want):
        if name == "bk":
            # zero in exact arithmetic (softmax ignores a shift shared by all
            # keys): held against gamma_k's scale
            scale = np.abs(want[5]).max()
        else:
            scale = np.abs(w).max()
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 2, 260, 64), (1, 1, 1024, 512),
                                   (8, 4, 16, 64)])
def test_sdpa_qknorm_fuse_matches_unfused(shape, monkeypatch):
    """On the CPU the fused route runs the same plain math: the full-block
    shape takes ``full_block_attention_qknorm``, the streaming shape and the
    plain path normalise first, and all agree with QKNORM_FUSE off."""
    q, k, v, norms = _inputs(shape, seed=5)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    qk = tuple(map(torch.from_numpy, norms))
    keep = torch.from_numpy(np.random.RandomState(6).rand(shape[0],
                                                          shape[2]) > 0.2)
    keep[:, 0] = True
    want = tattn.sdpa(*args, qk_norm=qk, key_mask=keep)
    called = []
    orig = tfa.full_block_attention_qknorm
    monkeypatch.setattr(tattn, "QKNORM_FUSE", True)
    monkeypatch.setattr(tfa, "full_block_attention_qknorm",
                        lambda *a, **kw: called.append(1) or orig(*a, **kw))
    got = tattn.sdpa(*args, qk_norm=qk, key_mask=keep)
    assert called == ([1] if shape == (2, 2, 260, 64) else [])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_qknorm_wrapper_raises_off_cpu_without_kernel():
    """A tensor that is neither on the CPU nor on a CUDA card gets no
    silent plain fallback."""
    x = torch.empty((1, 1, 300, 64), device="meta", dtype=torch.bfloat16)
    g = torch.empty((64,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.full_block_attention_qknorm(x, x, x, g, g, g, g, scale=0.125)
    assert tfa.full_block_attention_qknorm.launches == 0
