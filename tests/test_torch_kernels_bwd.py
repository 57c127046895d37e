"""The port's attention backwards on the CPU: the hand-written plain
backwards against ``jax.grad`` through the JAX package's Pallas kernels
(interpret mode) and against autograd of the port's own plain forwards, and
``sdpa``'s gradient on the kernel route against the JAX ``sdpa``. The CUDA
backward kernels themselves are held against these plain backwards on the
card by ``tests/test_torch_cuda.py``.

Tolerance: against JAX, fp32 on both sides, which differ only by the order
of fp32 sums (atol 1e-4 on gradients of unit-scale inputs and a unit-scale
cotangent). Against autograd, fp64 (atol 1e-10): the plain functions keep
fp64 inputs in fp64, so the two are the same function written two ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivae_tpu.ops import attention as jattn
from hivae_tpu.ops.pallas import flash_attention as jfa
from hivae_tpu_torch.ops import attention as tattn
from hivae_tpu_torch.ops.kernels import flash_attention as tfa

ATOL = 1e-4
F64_ATOL = 1e-10


def _arrays(shape, n, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(dtype) for _ in range(n)]


def _bias(b, sk, seed=1, full_row=None, dtype=np.float32):
    keep = np.random.RandomState(seed).rand(b, sk) > 0.3
    keep[:, 0] = True
    if full_row is not None:
        keep[full_row] = False
    return np.where(keep, 0.0, -1e30).astype(dtype)


def _jax_vjp(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _t(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("s,d", [
    pytest.param(260, 64, id="260"), pytest.param(266, 64, id="266"),
    # the MAE decoder's and the T2M joint block's head dims
    pytest.param(257, 32, id="257-d32"), pytest.param(269, 128, id="269-d128")])
@pytest.mark.parametrize("masked", [False, True])
def test_full_block_bwd_plain_matches_pallas(s, d, masked):
    q, k, v, do = _arrays((2, 2, s, d), 4, seed=s)
    bias = _bias(2, s) if masked else None
    scale = d ** -0.5
    want = _jax_vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, scale=scale,
        bias=None if bias is None else jnp.asarray(bias)), q, k, v, do)
    tq, tk, tv, tdo, tb = _t(q, k, v, do, bias)
    got = tfa.full_block_attention_bwd_plain(tq, tk, tv, tdo, scale=scale,
                                             bias=tb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,blocks,masked", [
    ((1, 2, 200, 16), (64, 64), True),     # 4 x 4 KV grid, ragged tail
    ((1, 2, 200, 16), (64, 64), False),
    ((1, 1, 64, 512), (512, 512), False),  # the SD-VAE head dim
    # batch 0's every key masked: each of its query rows attends to no key,
    # and both sides take P = exp(s - lse) from an lse of -1e30, which has
    # lost the log of the denominator (the fp32 kernels' parity with the TPU
    # kernels there). The Pallas forward's output of such a row is not the
    # plain version's uniform average, so the port's backward takes the
    # Pallas forward's out and lse there: the backward's formula is what
    # is held
    ((2, 2, 192, 16), (64, 64), "row"),
])
def test_stream_bwd_plain_matches_pallas(monkeypatch, shape, blocks,
                                         masked):
    monkeypatch.setattr(jfa, "_BQ", blocks[0])
    monkeypatch.setattr(jfa, "_BK", blocks[1])
    b, _, s, d = shape
    q, k, v, do = _arrays(shape, 4, seed=d)
    bias = np.zeros((b, s), np.float32)
    if masked == "row":
        bias[0] = -1e30
    elif masked:
        bias[:, -37:] = -1e30
    scale = d ** -0.5
    want = _jax_vjp(lambda q, k, v: jfa._flash_stream(
        q, k, v, jnp.asarray(bias), scale), q, k, v, do)
    tq, tk, tv, tdo, tb = _t(q, k, v, do, bias)
    out, lse = tfa.stream_attention_plain(tq, tk, tv, scale=scale, bias=tb)
    if masked == "row":
        out, lse = (torch.from_numpy(np.array(x)) for x in jfa.stream_fwd_lse(
            *map(jnp.asarray, (q, k, v, bias)), scale))
    got = tfa.stream_attention_bwd_plain(tq, tk, tv, tdo, out,
                                         lse.reshape(out.shape[:3] + (1,)),
                                         scale=scale, bias=tb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


def test_sdpa_kernel_route_gradient_matches_jax_with_qknorm():
    """Above 256^2 logits ``sdpa`` takes the kernel route (the full-block
    plain version on the CPU); its gradient in q, k, v and the four q/k
    norm parameters, with a key mask, against the JAX ``sdpa`` on its
    Pallas route."""
    shape = (2, 2, 300, 16)
    q, k, v, do = _arrays(shape, 4, seed=7)
    norms = _arrays((16,), 4, seed=8)
    keep = np.random.RandomState(9).rand(2, 300) > 0.4
    keep[:, 0] = True

    def jfn(q, k, v, *nrm):
        return jattn.sdpa(q, k, v, key_mask=jnp.asarray(keep), qk_norm=nrm,
                          implementation="pallas")

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v, *norms)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, *norms)]
    out = tattn.sdpa(*leaves[:3], key_mask=torch.from_numpy(keep),
                     qk_norm=tuple(leaves[3:]))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL,
                                   rtol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("kind", ["full_block", "stream"])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_bwd_is_the_gradient_of_the_plain_forward(kind, masked):
    """fp64: each hand-written backward equals autograd of its forward.
    The full-block case includes a fully masked row. The streaming one
    does not: it takes P = exp(s - lse), as the TPU kernels do, and at the
    -1e30 mask a row with no key to attend to has lse = -1e30, which has
    lost the log of its denominator."""
    shape = (2, 2, 70, 32)
    q, k, v, do = _t(*_arrays(shape, 4, seed=11, dtype=np.float64))
    full_row = 1 if kind == "full_block" else None
    bias = (torch.from_numpy(_bias(2, 70, full_row=full_row,
                                   dtype=np.float64)) if masked else None)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    if kind == "full_block":
        out = tfa.full_block_attention_plain(*leaves, scale=0.2, bias=bias)
        want = tfa.full_block_attention_bwd_plain(q, k, v, do, scale=0.2,
                                                  bias=bias)
    else:
        out, lse = tfa.stream_attention_plain(*leaves, scale=0.2, bias=bias)
        want = tfa.stream_attention_bwd_plain(q, k, v, do, out.detach(),
                                              lse.detach(), scale=0.2,
                                              bias=bias)
    got = torch.autograd.grad(out, leaves, do)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F64_ATOL,
                                   rtol=0)


def test_plain_bwd_passes_gradcheck():
    """``torch.autograd.gradcheck`` of the plain forwards in fp64 (their
    autograd graphs are what the hand-written backwards are held to)."""
    q, k, v = [x.requires_grad_() for x in _t(*_arrays(
        (1, 2, 9, 8), 3, seed=12, dtype=np.float64))]
    bias = torch.from_numpy(_bias(1, 9, dtype=np.float64))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.full_block_attention_plain(q, k, v, scale=0.3,
                                                       bias=bias), (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.stream_attention_plain(q, k, v, scale=0.3,
                                                   bias=bias)[0], (q, k, v))


@pytest.mark.parametrize("fn,args", [
    (tfa.full_block_attention_bwd, 7), (tfa.stream_attention_bwd_dq, 6),
    (tfa.stream_attention_bwd_dkv, 6)])
def test_backward_kernels_raise_off_the_card(fn, args):
    """A backward kernel's wrapper has no plain fallback: on a CPU tensor
    it raises and counts nothing."""
    x = torch.zeros((1, 1, 300, 64), dtype=torch.bfloat16)
    before = fn.launches
    with pytest.raises(ValueError, match="no kernel"):
        fn(*([x] * args), scale=0.125)
    assert fn.launches == before


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_stream_delta_plain_matches_jax(dtype):
    """``_delta`` (the delta pre-pass kernel's plain version, which
    ``stream_attention_delta`` runs on a CPU tensor) against the JAX
    ``stream_bwd``'s delta, sum(g.astype(f32) * out.astype(f32), -1), on
    the same numpy inputs (bf16-rounded where the dtype is bf16)."""
    g, out = _arrays((2, 3, 70, 64), 2, seed=21)
    if dtype == "bfloat16":
        g, out = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                  for x in (g, out))
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    want = np.asarray(jnp.sum(jnp.asarray(g, jdt).astype(jnp.float32)
                              * jnp.asarray(out, jdt).astype(jnp.float32),
                              axis=-1))
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    tg, tout = (torch.from_numpy(x).to(tdt) for x in (g, out))
    got = tfa._delta(tg, tout)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 70)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)
    assert torch.equal(tfa.stream_attention_delta(tg, tout), got)
