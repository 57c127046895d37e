"""The hand-written CUDA attention kernels vs their plain PyTorch versions
on the card. Every test here needs an NVIDIA card (``cuda`` marker) and
skips without one. The file imports no JAX, so it runs where only PyTorch
is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: bf16 inputs on both sides, outputs of unit scale; the kernel
and the plain version round P to bf16 at different points of the sum
(atol 2e-2). LSE is fp32 summed in another order (atol 1e-3). Gradients
are held relative to their largest element (``BWD_RTOL`` 2e-2): both sides
round P and dS to bf16, but from sums taken in another order, and the
full-block kernel takes delta = rowsum(dO * O) from the bf16 output where
its plain version takes rowsum(dP * P) in fp32."""

import numpy as np
import pytest
import torch

from hivae_tpu_torch.ops.kernels import flash_attention as tfa

ATOL = 2e-2
LSE_ATOL = 1e-3
BWD_RTOL = 2e-2


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _qkv(shape, seed, sk=None):
    """q, k, v on the card; k and v with ``sk`` rows when it is given."""
    rng = np.random.RandomState(seed)
    kv = shape if sk is None else shape[:2] + (sk, shape[3])
    return [torch.from_numpy(rng.randn(*x).astype(np.float32)).cuda()
            .bfloat16() for x in (shape, kv, kv)]


def _bias(b, sk, seed=1, full_row=None):
    keep = np.random.RandomState(seed).rand(b, sk) > 0.3
    if full_row is not None:
        keep[full_row] = False
    return torch.from_numpy(
        np.where(keep, 0.0, -1e30).astype(np.float32)).cuda()


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _rel(a, b):
    """max |a - b| over max |b|; the plain max |a - b| where b is all zero
    (the gradients of a softmax over one key)."""
    return _err(a, b) / (b.float().abs().max().item() or 1.0)


# (q shape, Sk or None for Sk = Sq, masked): every 16-key chunk boundary
# and both sides of the resident/streamed plans at D = 64 (the largest S
# that ``full_block_fits`` admits is ~1024), one ragged S at each other head
# dim, Sq != Sk, and the main path's shapes. A masked case has a fully
# masked row (batch 0).
FULL_BLOCK_CASES = (
    [((2, 4, s, 64), None, m) for s in (1, 63, 65, 129, 260, 266, 512, 700,
                                        1024) for m in (False, True)]
    + [((2, 3, 100, d), None, True) for d in (32, 96, 128)]
    + [((2, 4, 300, 64), 700, m) for m in (False, True)]
    + [((32, 8, 260, 64), None, False), ((16, 16, 266, 64), None, False),
       ((16, 16, 512, 64), None, False), ((16, 16, 512, 64), None, True)]
    # the camera joint block of a clip sampled with camera mask ratio 0.5:
    # 128 kept sites + 256 patches
    + [((16, 16, 384, 64), None, False), ((2, 16, 384, 64), None, True)]
    # the T2M head's joint block (16 x 128 heads over 4 + 1 + 8, 16 + 1 + 8
    # or 2 * 16 + 2 + 8 motion tokens and 256 patches) and the MAE
    # decoder's (16 x 32 over 1 + 256 tokens) and encoder's at mask 0
    + [((2, 16, 269, 128), None, False), ((16, 16, 281, 128), None, False),
       ((2, 16, 298, 128), None, True), ((4, 16, 257, 32), None, False),
       ((4, 16, 257, 32), None, True), ((2, 16, 257, 64), None, False)])


def _case(shape, sk, masked, seed):
    q, k, v = _qkv(shape, seed=seed, sk=sk)
    bias = _bias(shape[0], k.shape[2], full_row=0) if masked else None
    return q, k, v, bias


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,masked", FULL_BLOCK_CASES)
def test_full_block_kernel_matches_plain(shape, sk, masked):
    _cuda_or_skip()
    q, k, v, bias = _case(shape, sk, masked, seed=11)
    before = tfa.full_block_attention.launches
    got = tfa.full_block_attention(q, k, v, scale=0.125, bias=bias)
    want = tfa.full_block_attention_plain(q, k, v, scale=0.125, bias=bias)
    torch.cuda.synchronize()
    assert tfa.full_block_attention.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= ATOL
    if masked:  # a fully masked row is the uniform average of its values
        assert _err(got[0], v[0].float().mean(dim=1, keepdim=True)
                    .expand(got[0].shape)) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape,resident", [
    ((32, 8, 260, 64), True), ((16, 16, 266, 64), True),
    ((16, 16, 512, 64), False), ((4, 16, 1024, 64), False)])
def test_full_block_forward_plans_taken(shape, resident):
    """Both launch plans that ``_full_block_plan`` takes on the main path,
    K and V resident (Sk <= 320 at D = 64) and the streamed ring: the output
    and the row statistics the backward reads (m, the max of the base-2
    logits, and l, the denominator) against their plain values, with a
    fully masked row (batch 0: m ~ -1.44e30, l = Sk)."""
    _cuda_or_skip()
    assert tfa._full_block_plan(shape[2], shape[2], 64).resident == resident
    q, k, v, bias = _case(shape, None, True, seed=31)
    out, m, l = tfa._full_block_fwd(q, k, v, bias, 0.125, stats=True)
    t = tfa._logits(q, k, 0.125, bias) * 1.4426950408889634
    want_m = t.amax(dim=-1)
    want_l = torch.exp2(t - want_m[..., None]).sum(dim=-1)
    want = tfa.full_block_attention_plain(q, k, v, scale=0.125, bias=bias)
    torch.cuda.synchronize()
    assert _err(out, want) <= ATOL
    assert bool(((m - want_m).abs() <= LSE_ATOL + 1e-6 * want_m.abs()).all())
    assert bool(((l - want_l).abs() <= 1e-4 * want_l).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,masked", [
    ((17, 1, 1024, 512), False), ((1, 2, 600, 64), True),
    ((2, 1, 300, 256), True), ((16, 1, 1024, 640), False),
    ((4, 1, 1024, 640), True)])
def test_stream_kernel_matches_plain(shape, masked):
    _cuda_or_skip()
    q, k, v = _qkv(shape, seed=12)
    scale = shape[3] ** -0.5
    bias = _bias(shape[0], shape[2]) if masked else None
    before = tfa.stream_attention.launches
    out, lse = tfa.stream_attention(q, k, v, scale=scale, bias=bias)
    wo, wl = tfa.stream_attention_plain(q, k, v, scale=scale, bias=bias)
    torch.cuda.synchronize()
    assert tfa.stream_attention.launches == before + 1
    assert _err(out, wo) <= ATOL
    assert _err(lse, wl) <= LSE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 512, 640])
@pytest.mark.parametrize("masked", [False, True])
def test_stream_kernel_every_head_dim(d, masked):
    """Every head dim the kernel takes, ragged Sq and Sk (300 = 4.7 tiles),
    Sq != Sk, and under the mask a fully masked key row (batch 0), whose O
    is the uniform average and whose LSE is the plain version's."""
    _cuda_or_skip()
    q = _qkv((2, 2, 300, d), seed=30)[0]
    _, k, v = _qkv((2, 2, 300, d), seed=31, sk=173)
    scale = d ** -0.5
    bias = _bias(2, 173, full_row=0) if masked else None
    out, lse = tfa.stream_attention(q, k, v, scale=scale, bias=bias)
    wo, wl = tfa.stream_attention_plain(q, k, v, scale=scale, bias=bias)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    assert _err(out, wo) <= ATOL
    assert _err(lse, wl) <= LSE_ATOL
    if masked:
        uniform = v[0].float().mean(dim=1, keepdim=True)
        assert _err(out[0], uniform.expand_as(out[0])) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 512, 640])
def test_stream_kernel_lse_feeds_the_backward(d):
    """The kernel's O and LSE through the streaming backward kernels against
    the plain forward's O and LSE through the plain backward (masked keys,
    no fully masked row: a row with no key has no LSE, ROADMAP Queue 3)."""
    _cuda_or_skip()
    shape = (2, 2, 320, d)
    q, k, v = _qkv(shape, seed=32)
    do = _qkv(shape, seed=33)[0]
    scale = d ** -0.5
    bias = _bias(2, 320)
    out, lse = tfa.stream_attention(q, k, v, scale=scale, bias=bias)
    delta = (do.float() * out.float()).sum(-1)
    dq = tfa.stream_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale,
                                     bias=bias)
    dk, dv = tfa.stream_attention_bwd_dkv(q, k, v, do, lse, delta,
                                          scale=scale, bias=bias)
    wo, wl = tfa.stream_attention_plain(q, k, v, scale=scale, bias=bias)
    want = tfa.stream_attention_bwd_plain(q, k, v, do, wo, wl, scale=scale,
                                          bias=bias)
    torch.cuda.synchronize()
    for g, w in zip((dq, dk, dv), want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) <= BWD_RTOL


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take():
    """fp64 (no kernel's dtype), a head dim past the full-block kernels'
    widest tile (128) and one past the streaming kernels' (2048)."""
    _cuda_or_skip()
    q, k, v = _qkv((1, 2, 300, 64), seed=13)
    with pytest.raises(TypeError):
        tfa.full_block_attention(q.double(), k.double(), v.double(),
                                 scale=0.1)
    wide = [x.repeat(1, 1, 1, 3) for x in (q, k, v)]   # D 192
    with pytest.raises(ValueError, match="head dim"):
        tfa.full_block_attention(*wide, scale=0.1)
    wider = [torch.cat([x] * 32 + [x[..., :8]], dim=-1) for x in (q, k, v)]
    with pytest.raises(ValueError, match="head dim"):
        tfa.stream_attention(*wider, scale=0.1)   # D 2056


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,masked", FULL_BLOCK_CASES + [
    ((32, 8, 260, 64), None, True)])
def test_full_block_bwd_kernel_matches_plain(shape, sk, masked):
    _cuda_or_skip()
    q, k, v, bias = _case(shape, sk, masked, seed=14)
    do = _qkv(shape, seed=15)[0]
    out, m, l = tfa._full_block_fwd(q, k, v, bias, 0.125, stats=True)
    before = [tfa.full_block_attention_bwd.launches,
              tfa.full_block_attention_delta.launches]
    got = tfa.full_block_attention_bwd(q, k, v, do, out, m, l, scale=0.125,
                                       bias=bias)
    want = tfa.full_block_attention_bwd_plain(q, k, v, do, scale=0.125,
                                              bias=bias)
    torch.cuda.synchronize()
    assert [tfa.full_block_attention_bwd.launches,
            tfa.full_block_attention_delta.launches] == [b + 1 for b in before]
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) <= BWD_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 260, 64), (3, 2, 100, 96)])
def test_full_block_delta_kernel_matches_plain(shape):
    """delta = rowsum(dO * O) and 1/l: fp32 sums in another order (rtol
    1e-5 of the row's |dO| . |O|); 1/l is the same IEEE reciprocal."""
    _cuda_or_skip()
    do, out, _ = _qkv(shape, seed=28)
    l = torch.rand(shape[:3], device="cuda") * 100 + 1
    delta, inv_l = tfa.full_block_attention_delta(do, out, l)
    want_d, want_il = tfa.full_block_attention_delta_plain(do, out, l)
    scale = (do.float().abs() * out.float().abs()).sum(-1)
    assert bool(((delta - want_d).abs() <= 1e-5 * scale + 1e-6).all())
    assert torch.equal(inv_l, want_il)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,masked", [
    ((16, 16, 512, 64), None, True), ((32, 8, 260, 64), None, False),
    ((2, 4, 300, 64), 700, True), ((4, 16, 1024, 64), None, False),
    ((2, 16, 281, 128), None, False), ((4, 16, 257, 32), None, True)])
def test_full_block_kernels_are_deterministic(shape, sk, masked):
    """Two launches on the same inputs give the same bits, forward and
    backward (no atomics; every sum in a fixed order)."""
    _cuda_or_skip()
    q, k, v, bias = _case(shape, sk, masked, seed=29)
    do = _qkv(shape, seed=30)[0]
    runs = []
    for _ in range(2):
        out, m, l = tfa._full_block_fwd(q, k, v, bias, 0.125, stats=True)
        runs.append((out, m, l) + tfa.full_block_attention_bwd(
            q, k, v, do, out, m, l, scale=0.125, bias=bias))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,masked", [
    ((16, 1, 1024, 512), False), ((4, 1, 1024, 512), True),
    ((1, 2, 600, 64), True), ((2, 1, 300, 256), True),
    ((4, 16, 2048, 64), False), ((2, 8, 2048, 128), False),
    ((2, 8, 2048, 64), True), ((1, 3, 333, 128), True),
    # the CNN motion AE's MapConv at D 640 (32-row walked tiles), and a
    # ragged S
    ((16, 1, 1024, 640), False), ((4, 1, 1024, 640), True),
    ((2, 1, 300, 640), True)])
def test_stream_bwd_kernels_match_plain(shape, masked):
    _cuda_or_skip()
    q, k, v = _qkv(shape, seed=16)
    do = _qkv(shape, seed=17)[0]
    scale = shape[3] ** -0.5
    bias = None
    if masked:  # and one whole key block of 32 masked in every row
        bias = _bias(shape[0], shape[2])
        bias[:, 64:96] = -1e30
    out, lse = tfa.stream_attention(q, k, v, scale=scale, bias=bias)
    delta = (do.float() * out.float()).sum(-1)
    n_dq = tfa.stream_attention_bwd_dq.launches
    n_dkv = tfa.stream_attention_bwd_dkv.launches
    dq = tfa.stream_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale,
                                     bias=bias)
    dk, dv = tfa.stream_attention_bwd_dkv(q, k, v, do, lse, delta,
                                          scale=scale, bias=bias)
    want = tfa.stream_attention_bwd_plain(q, k, v, do, out, lse, scale=scale,
                                          bias=bias)
    torch.cuda.synchronize()
    assert tfa.stream_attention_bwd_dq.launches == n_dq + 1
    assert tfa.stream_attention_bwd_dkv.launches == n_dkv + 1
    for g, w in zip((dq, dk, dv), want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) <= BWD_RTOL
    if masked:  # the masked key block gets no gradient
        assert dk[:, :, 64:96].abs().max().item() == 0
        assert dv[:, :, 64:96].abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 8, 260, 64), (2, 1, 1024, 512),
                                   (2, 1, 1024, 640)])
def test_sdpa_gradient_runs_the_backward_kernels(shape):
    """On a CUDA tensor that requires grad, sdpa's output has a grad_fn and
    its backward launches the port's backward kernel(s), once each."""
    _cuda_or_skip()
    from hivae_tpu_torch.ops import attention as tattn
    q, k, v = [x.requires_grad_() for x in _qkv(shape, seed=18)]
    counters = [tfa.full_block_attention_bwd, tfa.stream_attention_bwd_dq,
                tfa.stream_attention_bwd_dkv, tfa.stream_attention_delta]
    before = [c.launches for c in counters]
    out = tattn.sdpa(q, k, v)
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    ran = [c.launches - b for c, b in zip(counters, before)]
    assert ran == ([1, 0, 0, 0] if shape[3] == 64 else [0, 1, 1, 1])
    assert all(x.grad is not None and bool(torch.isfinite(x.grad).all())
               for x in (q, k, v))


def _ffn_inputs(m, k, n, seed):
    """Seeded FFN-up inputs on the card: per-token int8 of a random bf16
    activation, a per-channel int8 weight, fp32 scales and bias."""
    from hivae_tpu_torch.ops import quant as tq
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda().bfloat16()
    w = torch.from_numpy((rng.randn(n, k) / np.sqrt(k)).astype(np.float32))
    w8, ws = tq._quantize_kernel(w.cuda())
    bias = torch.from_numpy((0.1 * rng.randn(n)).astype(np.float32)).cuda()
    xq, sx = tq.quant_act(x)
    return xq, sx, w8, ws, bias


def _ffn_plain(xq, sx, w8, ws, bias):
    """The plain version on the card; fewer than 17 rows (``torch._int_mm``
    needs more) are padded with zero rows, which change no other row."""
    from hivae_tpu_torch.ops.kernels import quant_ffn as tqf
    m = xq.shape[0]
    if m > 16:
        return tqf.fused_ffn_up_quant_plain(xq, sx, w8, ws, bias)
    pad = 17 - m
    xq = torch.cat([xq, xq.new_zeros((pad, xq.shape[1]))])
    sx = torch.cat([sx, sx.new_ones((pad, 1))])
    yq, sy = tqf.fused_ffn_up_quant_plain(xq, sx, w8, ws, bias)
    return yq[:m], sy[:m]


def _int8_agreement(yq, sy, wq, ws):
    """(max |yq - want|, share of elements off by one, max relative error of
    the scales, relative L2 error of the dequantised values)."""
    d = (yq.int() - wq.int()).abs()
    rel_s = ((sy - ws).abs() / ws).max().item()
    got, want = yq.float() * sy, wq.float() * ws
    l2 = ((got - want).norm() / want.norm()).item()
    return d.max().item(), (d == 1).float().mean().item(), rel_s, l2


# the int8 clip's three FFN-up shapes
FFN_FLAGSHIP = [(4256, 1024, 4096), (8192, 1024, 4096), (4096, 1024, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", FFN_FLAGSHIP + [
    (70, 128, 512), (1, 1024, 4096), (70, 1024, 4096), (200, 1024, 4096),
    (4256, 1024, 8192), (130, 256, 640)])
def test_quant_ffn_kernel_matches_plain(m, k, n):
    """int8 within +-1 everywhere and off by one in at most 0.1% of the
    elements, scales within 1e-6 relative, dequantised values within 1e-3
    relative L2. (The kernel spells out the plain version's roundings and
    gives its bits on the H100; the tolerance allows one rounding edge
    crossed by an ulp of another tanhf.)"""
    _cuda_or_skip()
    from hivae_tpu_torch.ops.kernels import quant_ffn as tqf
    args = _ffn_inputs(m, k, n, seed=19)
    before = tqf.fused_ffn_up_quant.launches
    yq, sy = tqf.fused_ffn_up_quant(*args)
    wq, ws = _ffn_plain(*args)
    torch.cuda.synchronize()
    assert tqf.fused_ffn_up_quant.launches == before + 1
    assert yq.dtype == torch.int8 and yq.shape == (m, n) and sy.shape == (m, 1)
    worst, off_by_one, rel_s, l2 = _int8_agreement(yq, sy, wq, ws)
    assert worst <= 1 and off_by_one <= 1e-3
    assert rel_s <= 1e-6 and l2 <= 1e-3


@pytest.mark.cuda
def test_quant_ffn_kernel_rejects_unaligned():
    _cuda_or_skip()
    from hivae_tpu_torch.ops.kernels import quant_ffn as tqf
    xq, sx, w8, ws, bias = _ffn_inputs(64, 96, 512, seed=20)
    with pytest.raises(ValueError, match="multiples"):
        tqf.fused_ffn_up_quant(xq, sx, w8, ws, bias)


@pytest.mark.cuda
def test_quant_ffn_kernel_rejects_unaligned_n():
    _cuda_or_skip()
    from hivae_tpu_torch.ops.kernels import quant_ffn as tqf
    xq, sx, w8, ws, bias = _ffn_inputs(64, 128, 200, seed=20)
    with pytest.raises(ValueError, match="multiples"):
        tqf.fused_ffn_up_quant(xq, sx, w8, ws, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", FFN_FLAGSHIP + [(4256, 1024, 8192),
                                                  (200, 1024, 4096),
                                                  (68, 1024, 4096)])
def test_quant_ffn_kernel_is_bit_exact(m, k, n):
    """Two launches give the same yq and sy, and both are the plain
    version's bits: the cluster's row maximum does not depend on the order
    of its partials, and the epilogue spells out the plain roundings. M 68
    is the A2M head's FFN (4 tokens of the reference and 16 frames)."""
    _cuda_or_skip()
    from hivae_tpu_torch.ops.kernels import quant_ffn as tqf
    args = _ffn_inputs(m, k, n, seed=21)
    first = tqf.fused_ffn_up_quant(*args)
    again = tqf.fused_ffn_up_quant(*args)
    want = tqf.fused_ffn_up_quant_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(a, b) for a, b in zip(first, want))


def _norms(d, seed):
    """gamma, beta away from (1, 0), fp32 on the card."""
    rng = np.random.RandomState(seed)
    vals = [1 + 0.5 * rng.randn(d), 0.3 * rng.randn(d),
            1 + 0.5 * rng.randn(d), 0.3 * rng.randn(d)]
    return [torch.from_numpy(x.astype(np.float32)).cuda() for x in vals]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,masked", [
    ((32, 8, 260, 64), None, False), ((16, 16, 266, 64), None, False),
    ((16, 16, 512, 64), None, False), ((16, 16, 512, 64), None, True),
    ((4, 16, 1024, 64), None, False), ((2, 4, 300, 64), 700, True),
    ((2, 3, 100, 32), None, True), ((2, 3, 100, 96), None, False),
    ((2, 3, 100, 128), None, True)])
def test_full_block_qknorm_kernel_matches_plain(shape, sk, masked):
    """The qk-norm variant of the forward under both plans (resident at
    260/266, the streamed ring at 512 and beyond), every head dim, Sq != Sk;
    a fully masked row stays the uniform average of its values."""
    _cuda_or_skip()
    q, k, v, bias = _case(shape, sk, masked, seed=21)
    q, k = 3 * q + 1, 2 * k - 1   # raw, far from normalised
    norms = _norms(shape[3], seed=22)
    before = tfa.full_block_attention_qknorm.launches
    got = tfa.full_block_attention_qknorm(q, k, v, *norms, scale=0.125,
                                          bias=bias)
    want = tfa.full_block_attention_qknorm_plain(q, k, v, *norms, scale=0.125,
                                                 bias=bias)
    torch.cuda.synchronize()
    assert tfa.full_block_attention_qknorm.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= ATOL
    if masked:
        assert _err(got[0], v[0].float().mean(dim=1, keepdim=True)
                    .expand(got[0].shape)) <= ATOL


@pytest.mark.cuda
def test_full_block_qknorm_gradients_match_plain():
    """Autograd through the fused kernel (its backward recomputes the
    unfused composition on the full-block kernels) against autograd through
    the plain version: q, k, v and the four norm parameters. beta_k's
    gradient is zero in exact arithmetic (a shift of every key by one vector
    adds a constant to each row of logits, which the softmax ignores), so
    both sides hold only rounding noise there: it is held to ``BWD_RTOL``
    of gamma_k's largest gradient instead of its own."""
    _cuda_or_skip()
    shape = (16, 16, 512, 64)
    q, k, v = _qkv(shape, seed=23)
    do = _qkv(shape, seed=24)[0]
    norms = _norms(64, seed=25)
    leaves = [x.detach().requires_grad_() for x in [q, k, v] + norms]
    tfa.full_block_attention_qknorm(*leaves, scale=0.125).backward(do)
    got = [x.grad for x in leaves]
    leaves = [x.detach().requires_grad_() for x in [q, k, v] + norms]
    tfa.full_block_attention_qknorm_plain(*leaves, scale=0.125).backward(do)
    want = [x.grad for x in leaves]
    for g, w in zip(got[:6], want[:6]):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) <= BWD_RTOL
    assert _err(got[6], want[6]) <= BWD_RTOL * want[5].abs().max().item()


@pytest.mark.cuda
def test_sdpa_qknorm_fuse_launches_the_fused_kernel(monkeypatch):
    _cuda_or_skip()
    from hivae_tpu_torch.ops import attention as tattn
    q, k, v = _qkv((4, 8, 260, 64), seed=26)
    norms = tuple(_norms(64, seed=27))
    want = tattn.sdpa(q, k, v, qk_norm=norms)
    monkeypatch.setattr(tattn, "QKNORM_FUSE", True)
    counters = [tfa.full_block_attention_qknorm, tfa.full_block_attention]
    before = [c.launches for c in counters]
    got = tattn.sdpa(q, k, v, qk_norm=norms)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 0]
    assert _err(got, want) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape,masked", [
    ((16, 1, 1024, 512), False), ((2, 8, 2048, 64), True),
    ((2, 2, 700, 128), True), ((2, 1, 300, 256), False),
    ((4, 1, 1024, 640), True)])
def test_stream_bwd_kernels_are_deterministic(shape, masked):
    """Two launches of the delta, dQ and dK/dV kernels on the same inputs
    give the same bits (no atomics; from D = 512 both cluster CTAs add the
    same two partials)."""
    _cuda_or_skip()
    q, k, v = _qkv(shape, seed=34)
    do = _qkv(shape, seed=35)[0]
    scale = shape[3] ** -0.5
    bias = _bias(shape[0], shape[2]) if masked else None
    out, lse = tfa.stream_attention(q, k, v, scale=scale, bias=bias)
    runs = []
    for _ in range(2):
        delta = tfa.stream_attention_delta(do, out)
        runs.append((delta, tfa.stream_attention_bwd_dq(
            q, k, v, do, lse, delta, scale=scale, bias=bias))
            + tfa.stream_attention_bwd_dkv(q, k, v, do, lse, delta,
                                           scale=scale, bias=bias))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("d,cols,tile", [(512, 256, 64), (640, 320, 32)])
def test_stream_bwd_cluster_plan_is_the_one_launched(monkeypatch, d, cols,
                                                     tile):
    """At D = 512 the plan is a cluster of 2 CTAs of 256 columns (at
    D = 640 of 320, walking 32-row tiles), and the kernels launch under
    it; any other plan is refused by the C entry points, not run."""
    import dataclasses
    _cuda_or_skip()
    plan = tfa._stream_bwd_plan(d)
    assert (plan.cluster, plan.cols, plan.rows, plan.tile) == (2, cols, 64,
                                                              tile)
    shape = (2, 1, 256, d)
    q, k, v = _qkv(shape, seed=36)
    do = _qkv(shape, seed=37)[0]
    out, lse = tfa.stream_attention(q, k, v, scale=0.05)
    delta = tfa.stream_attention_delta(do, out)
    n = tfa.stream_attention_bwd_dq.launches
    tfa.stream_attention_bwd_dq(q, k, v, do, lse, delta, scale=0.05)
    assert tfa.stream_attention_bwd_dq.launches == n + 1
    for other in (dataclasses.replace(plan, cluster=1, cols=d),
                  dataclasses.replace(plan, smem=plan.smem - 1024)):
        monkeypatch.setattr(tfa, "_stream_bwd_plan", lambda d: other)
        for fn in (tfa.stream_attention_bwd_dq, tfa.stream_attention_bwd_dkv):
            with pytest.raises(RuntimeError, match="launch plan"):
                fn(q, k, v, do, lse, delta, scale=0.05)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 300, 64), (3, 2, 129, 512),
                                   (2, 2, 70, 128), (1, 1, 65, 256),
                                   (3, 1, 129, 640)])
def test_stream_delta_kernel_matches_plain(shape):
    """delta = rowsum(dO * O): fp32 sums in another order (rtol 1e-5 of
    the row's |dO| . |O|), one launch."""
    _cuda_or_skip()
    do, out, _ = _qkv(shape, seed=38)
    n = tfa.stream_attention_delta.launches
    delta = tfa.stream_attention_delta(do, out)
    want = tfa._delta(do, out)
    torch.cuda.synchronize()
    assert tfa.stream_attention_delta.launches == n + 1
    scale = (do.float().abs() * out.float().abs()).sum(-1)
    assert bool(((delta - want).abs() <= 1e-5 * scale + 1e-6).all())


SDPA_DTYPE_SHAPES = [((2, 16, 260, 64), True), ((4, 1, 1024, 512), False)]


def _sdpa_case(shape, masked, dtype, grad=False):
    q, k, v = (x.float().to(dtype).requires_grad_(grad)
               for x in _qkv(shape, seed=39))
    mask = None
    if masked:
        mask = torch.from_numpy(
            np.random.RandomState(40).rand(shape[0], shape[2]) > 0.3).cuda()
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16])
@pytest.mark.parametrize("shape,masked", SDPA_DTYPE_SHAPES)
def test_sdpa_off_the_kernel_dtypes_takes_the_plain_path(dtype, shape,
                                                         masked):
    """Above 256^2 logits past every kernel's head dims (D 2056; every
    multiple of 8 up to 2048 in fp16, bf16 and fp32 has a kernel): ``sdpa``
    takes the plain path (no kernel launch, one count of ``sdpa_plain``)
    and returns its values."""
    _cuda_or_skip()
    from hivae_tpu_torch.ops import attention as tattn
    shape = shape[:3] + (2056,)
    q, k, v, mask = _sdpa_case(shape, masked, dtype)
    counters = [tfa.full_block_attention, tfa.stream_attention,
                tfa.full_block_attention_f16, tfa.stream_attention_f16,
                tattn.sdpa_plain]
    before = [c.launches for c in counters]
    got = tattn.sdpa(q, k, v, key_mask=mask)
    want = tattn._sdpa_plain(q, k, v, shape[3] ** -0.5, mask)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before[:4] + [before[4] + 1]
    assert got.dtype == dtype
    assert _err(got, want) <= ATOL


# fp32 streaming forward: three TF32 products (hi/lo split) on tensor cores
# that truncate as they accumulate, against full fp32 ones (1-2e-6); one
# TF32 product would be ~2e-4
F32_ATOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,masked", [
    ((16, 1, 1024, 512), False), ((17, 1, 1024, 512), True),
    ((3, 2, 333, 512), True), ((2, 2, 1000, 64), True),
    ((2, 2, 1024, 128), False), ((2, 1, 1030, 256), True),
    ((2, 1, 1024, 640), True),
    # ragged against the 64-row CTA and the key tiles (64 / 32 / 16 / 8
    # keys at D 128 / 256 / 512 / 640)
    ((1, 2, 77, 512), True), ((2, 1, 100, 640), False),
    ((1, 3, 70, 128), True), ((2, 1, 45, 256), False)])
def test_stream_f32_kernel_matches_plain(shape, masked):
    """The fp32 variant against the fp32 plain version: outputs and LSE
    within F32_ATOL, a fully masked key row (batch 0) the uniform average,
    two launches to the same bits, counted in ``stream_attention_f32``."""
    _cuda_or_skip()
    q, k, v = (x.float() for x in _qkv(shape, seed=51))
    bias = _bias(shape[0], shape[2], seed=52, full_row=0) if masked else None
    n = tfa.stream_attention_f32.launches
    out, lse = tfa.stream_attention(q, k, v, scale=shape[3] ** -0.5,
                                    bias=bias)
    again, _ = tfa.stream_attention(q, k, v, scale=shape[3] ** -0.5,
                                    bias=bias)
    want, wl = tfa.stream_attention_plain(q, k, v, scale=shape[3] ** -0.5,
                                          bias=bias)
    torch.cuda.synchronize()
    assert tfa.stream_attention_f32.launches == n + 2
    assert out.dtype == torch.float32 and torch.equal(out, again)
    assert _err(out, want) <= F32_ATOL and _err(lse, wl) <= F32_ATOL
    if masked:
        assert _err(out[0], v[0].mean(dim=1, keepdim=True)) <= F32_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("shape,masked", SDPA_DTYPE_SHAPES)
def test_sdpa_routes_fp32_to_the_kernels(shape, masked, grad):
    """fp32 above 256^2 logits: ``sdpa`` launches the fp32 kernels of the
    route its shape picks (the full-block forward at the object encoder's,
    the streaming forward at the SD-VAE mid-block's), and with a gradient
    their delta pre-pass and backward, one each; ``sdpa_plain`` counts
    nothing; the output and gradients within F32_ATOL x max(1, max|plain|)
    of the plain path's."""
    _cuda_or_skip()
    from hivae_tpu_torch.ops import attention as tattn
    q, k, v, mask = _sdpa_case(shape, masked, torch.float32, grad)
    if shape[3] == 512:
        names = ["stream_attention_f32", "stream_attention_delta_f32",
                 "stream_attention_bwd_dq_f32", "stream_attention_bwd_dkv_f32"]
    else:
        names = ["full_block_attention_f32", "full_block_attention_delta_f32",
                 "full_block_attention_bwd_f32"]
    counters = [getattr(tfa, n) for n in names] + [tattn.sdpa_plain]
    before = [c.launches for c in counters]
    got = tattn.sdpa(q, k, v, key_mask=mask)
    ref = [x.detach().clone().requires_grad_(grad) for x in (q, k, v)]
    want = tattn._sdpa_plain(*ref, shape[3] ** -0.5, mask)
    pairs = [(got, want)]
    if grad:
        do = torch.randn_like(got)
        pairs += zip(torch.autograd.grad(got, (q, k, v), do),
                     torch.autograd.grad(want, ref, do))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == (
        [1] * (len(names) if grad else 1)
        + [0] * (0 if grad else len(names) - 1) + [0])
    for g, w in pairs:
        assert g.dtype == torch.float32
        assert _err(g, w) <= F32_ATOL * max(1.0, w.abs().max().item())


# (q shape, Sk or None, masked) of the fp32 full-block kernels: the main
# path's sites at N = 2 (`--mp no`), ragged and Sq != Sk, every head dim, a
# masked case with a fully masked key row (batch 0); then ragged against
# the plan's blocks (``_full_block_f32_plan``): Sq one past and one short
# of the forward's 128 rows and the backward's 128 (D 64) or 64 (D 128)
# resident rows, Sk of the forward's 64 (D 64) or 32 (D 128) keys and the
# backward's 32 or 16 walked rows; and Sq != Sk at D 96
FULL_BLOCK_F32_CASES = [
    ((64, 8, 260, 64), None, False), ((32, 16, 266, 64), None, False),
    ((32, 16, 512, 64), None, True), ((2, 4, 300, 64), 700, True),
    ((2, 3, 65, 64), None, True), ((2, 2, 1, 64), 33, False),
    ((3, 2, 100, 32), None, True), ((2, 2, 129, 96), None, True),
    ((2, 16, 269, 128), None, False), ((1, 2, 70, 128), 150, True),
    ((2, 2, 129, 64), 65, True), ((2, 2, 127, 64), 63, False),
    ((2, 2, 129, 64), 31, False), ((2, 2, 127, 64), 33, True),
    ((2, 2, 129, 128), 33, True), ((2, 2, 127, 128), 31, False),
    ((2, 2, 65, 128), 17, False), ((2, 2, 63, 128), 15, True),
    ((2, 3, 100, 96), 70, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,masked", FULL_BLOCK_F32_CASES)
def test_full_block_f32_kernels_match_plain(shape, sk, masked):
    """The fp32 full-block forward, its qk-norm variant, the backward and
    its delta pre-pass against their fp32 plain versions within F32_ATOL x
    max(1, max|plain|): the forward's m and l as the plain logits give
    them, a fully masked row the uniform average, two launches of each to
    the same bits, counted on the fp32 counters."""
    _cuda_or_skip()
    q, k, v, bias = (None if x is None else x.float()
                     for x in _case(shape, sk, masked, seed=56))
    do = _qkv(shape, seed=57)[0].float()
    rng = np.random.RandomState(58)
    norms = [torch.from_numpy((m + sd * rng.randn(shape[3])).astype(
        np.float32)).cuda() for m, sd in ((1, .5), (0, .3), (1, .5), (0, .3))]
    scale = shape[3] ** -0.5
    kw = dict(scale=scale, bias=bias)
    counters = [tfa.full_block_attention_f32,
                tfa.full_block_attention_qknorm_f32,
                tfa.full_block_attention_bwd_f32,
                tfa.full_block_attention_delta_f32]
    before = [c.launches for c in counters]
    out, m, l = tfa._full_block_fwd(q, k, v, bias, scale, stats=True)
    again = tfa.full_block_attention(q, k, v, **kw)
    qn = [tfa.full_block_attention_qknorm(q, k, v, *norms, **kw)
          for _ in range(2)]
    grads = [tfa.full_block_attention_bwd(q, k, v, do, out, m, l, **kw)
             for _ in range(2)]
    delta, inv_l = tfa.full_block_attention_delta(do, out, l)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2, 3]
    assert torch.equal(out, again) and torch.equal(*qn)
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    t = tfa._logits(q, k, scale, bias) * 1.4426950408889634
    want_m = t.amax(dim=-1)
    want_l = torch.exp2(t - want_m[..., None]).sum(dim=-1)
    assert bool(((m - want_m).abs() <= F32_ATOL * (1 + want_m.abs())).all())
    assert bool(((l - want_l).abs() <= F32_ATOL * want_l).all())
    wd, wil = tfa.full_block_attention_delta_plain(do, out, l)
    assert torch.equal(inv_l, wil)
    for g, w in [(out, tfa.full_block_attention_plain(q, k, v, **kw)),
                 (qn[0], tfa.full_block_attention_qknorm_plain(
                     q, k, v, *norms, **kw)), (delta, wd)] + list(zip(
                         grads[0], tfa.full_block_attention_bwd_plain(
                             q, k, v, do, **kw))):
        assert bool(torch.isfinite(g).all())
        assert _err(g, w) <= F32_ATOL * max(1.0, w.abs().max().item())
    if masked:
        assert _err(out[0], v[0].mean(dim=1, keepdim=True)) <= F32_ATOL


# (q shape, Sk or None, masked) of the fp32 streaming backward: every head
# dim, ragged against its plans' rows and tiles, Sq != Sk (at D 512 and
# 640 against the cluster's 64-row blocks and 16- or 32-row walked tiles);
# a masked case masks the key block 64:128 in every row too (no row without
# a key)
STREAM_BWD_F32_CASES = [
    ((16, 1, 1024, 512), None, False), ((2, 1, 333, 512), 300, True),
    ((2, 1, 1000, 512), 1000, True),
    ((4, 1, 1024, 640), None, True), ((1, 1, 100, 640), 77, False),
    ((2, 1, 1000, 640), 700, True),
    ((2, 2, 300, 256), None, True), ((2, 3, 190, 128), 260, True),
    ((1, 16, 2048, 64), None, False), ((2, 2, 129, 64), None, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,masked", STREAM_BWD_F32_CASES)
def test_stream_bwd_f32_kernels_match_plain(shape, sk, masked):
    """The fp32 streaming delta, dQ and dK/dV kernels from the fp32
    forward's LSE against the fp32 plain backward within F32_ATOL x max(1,
    max|plain|), two launches to the same bits, a fully masked key block
    with no gradient, counted on the fp32 counters."""
    _cuda_or_skip()
    q, k, v = (x.float() for x in _qkv(shape, seed=59, sk=sk))
    do = _qkv(shape, seed=60)[0].float()
    scale = shape[3] ** -0.5
    bias = None
    if masked:
        bias = _bias(shape[0], k.shape[2], seed=61)
        bias[:, 0] = 0.0
        bias[:, 64:128] = -1e30
    kw = dict(scale=scale, bias=bias)
    counters = [tfa.stream_attention_delta_f32,
                tfa.stream_attention_bwd_dq_f32,
                tfa.stream_attention_bwd_dkv_f32]
    before = [c.launches for c in counters]
    out, lse = tfa.stream_attention(q, k, v, **kw)
    runs = []
    for _ in range(2):
        delta = tfa.stream_attention_delta(do, out)
        runs.append((delta,
                     tfa.stream_attention_bwd_dq(q, k, v, do, lse, delta,
                                                 **kw),
                     *tfa.stream_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                   **kw)))
    want = (tfa._delta(do, out),) + tfa.stream_attention_bwd_plain(
        q, k, v, do, out, lse, **kw)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    for g, w in zip(runs[0], want):
        assert bool(torch.isfinite(g).all())
        assert _err(g, w) <= F32_ATOL * max(1.0, w.abs().max().item())
    if masked and k.shape[2] > 128:
        assert runs[0][2][:, :, 64:128].abs().max().item() == 0
        assert runs[0][3][:, :, 64:128].abs().max().item() == 0


@pytest.mark.cuda
def test_exported_program_launches_the_kernels():
    """A module exported with ``torch.export`` on the card keeps the
    kernels as custom ops: the loaded program launches each once a call,
    counted, with the live module's bits."""
    _cuda_or_skip()
    import io
    from hivae_tpu_torch.ops import attention as tattn

    class M(torch.nn.Module):
        def forward(self, q, x):
            return tattn.sdpa(q, q, q), tattn.sdpa(x, x, x)

    q = _qkv((2, 4, 512, 64), seed=54)[0]
    x = _qkv((2, 1, 1024, 512), seed=55)[0].float()
    with torch.no_grad():
        program = torch.export.export(M(), (q, x))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    loaded = torch.export.load(buf).module()
    counters = [tfa.full_block_attention, tfa.stream_attention_f32]
    before = [c.launches for c in counters]
    with torch.no_grad():
        got = loaded(q, x)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [b + 1 for b in before]
    want = M()(q, x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernel", [
    ((2, 16, 260, 64), "full_block_attention"),
    ((4, 1, 1024, 512), "stream_attention")])
def test_sdpa_copies_a_layout_the_kernels_cannot_read(shape, kernel):
    """bf16 operands with a strided last dim (every other column of a
    wider tensor): ``sdpa`` copies them to the kernels' layout and launches
    the kernel its shape picks, with the plain path's values."""
    _cuda_or_skip()
    from hivae_tpu_torch.ops import attention as tattn
    wide = [x.repeat_interleave(2, dim=-1)
            for x in _qkv(shape, seed=42)]
    q, k, v = (x[..., ::2] for x in wide)
    counter = getattr(tfa, kernel)
    before = [counter.launches, tattn.sdpa_plain.launches]
    got = tattn.sdpa(q, k, v)
    want = tattn._sdpa_plain(q, k, v, shape[3] ** -0.5, None)
    torch.cuda.synchronize()
    assert [counter.launches, tattn.sdpa_plain.launches] == [
        before[0] + 1, before[1]]
    assert _err(got, want) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 17])
def test_int8_layers_at_few_rows(m):
    """``quant_dense`` and ``fused_quant_ffn`` at M 1, 16 (padded inside
    ``int8_mm`` for torch._int_mm) and 17 on the card against the same
    calls on the CPU (their plain versions): relative L2 within 1e-3 (the
    FFN-up kernel may be one int8 step off its plain version on a few
    elements)."""
    _cuda_or_skip()
    from hivae_tpu_torch.ops import quant as tq
    rng = np.random.RandomState(41 + m)

    def entry(n, k):
        w = torch.from_numpy((rng.randn(n, k) / np.sqrt(k)).astype(np.float32))
        w8, ws = tq._quantize_kernel(w.cuda())
        b = torch.from_numpy((0.1 * rng.randn(n)).astype(np.float32)).cuda()
        return {"w8": w8, "scale": ws, "bias": b}

    up, down = entry(4096, 1024), entry(1024, 4096)
    x = torch.from_numpy(rng.randn(m, 1024).astype(np.float32)).cuda()
    x = x.bfloat16()
    got = [tq.quant_dense(x, up["w8"], up["scale"], up["bias"]),
           tq.fused_quant_ffn(x, up, down)]
    cpu = [{n: t.cpu() for n, t in e.items()} for e in (up, down)]
    want = [tq.quant_dense(x.cpu(), cpu[0]["w8"], cpu[0]["scale"],
                           cpu[0]["bias"]),
            tq.fused_quant_ffn(x.cpu(), *cpu)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        rel = (g.float().cpu() - w.float()).norm() / w.float().norm()
        assert rel.item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", [
    # camera mask ratio 0.5: the camera joint block at 128 + 256 tokens
    ((2, 16, 384, 64), "full_block"),
    # object mask ratio 0.5: the object encoder at 4 + 128 tokens, below
    # 256^2 logits, where the JAX package also takes its XLA path
    ((2, 8, 132, 64), "plain")])
def test_sdpa_routes_the_masked_clip_shapes(shape, route):
    """The masked clip's new attention shapes in bf16: the camera joint
    block launches the full-block kernel; the shortened object encoder
    takes the uncounted plain path (not ``sdpa_plain``)."""
    _cuda_or_skip()
    from hivae_tpu_torch.ops import attention as tattn
    q, k, v = _qkv(shape, seed=44)
    mask = torch.from_numpy(
        np.random.RandomState(45).rand(shape[0], shape[2]) > 0.3).cuda()
    counters = [tfa.full_block_attention, tfa.stream_attention,
                tattn.sdpa_plain]
    before = [c.launches for c in counters]
    assert tattn.kernel_route(q, k, v) == route
    got = tattn.sdpa(q, k, v, key_mask=mask)
    want = tattn._sdpa_plain(q, k, v, shape[3] ** -0.5, mask)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == ([1, 0, 0] if route == "full_block" else [0, 0, 0])
    assert _err(got, want) <= ATOL


# ---------------------------------------------------------------------------
# fp16 (the 16-bit kernels built with -DHV_F16) and head dims off the
# kernels' tiles (each runs on the smallest tile >= it, zero-filled past
# it). Tolerances as above: bf16 and fp16 alike (fp16 has the finer
# mantissa), fp32 F32_ATOL x max(1, max|plain|).
# ---------------------------------------------------------------------------

ODD_DIMS = (8, 24, 40, 72, 80, 136, 200, 320, 600)
KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_SUFFIX = {torch.bfloat16: "", torch.float16: "_f16", torch.float32: "_f32"}


def _counter(name, dtype):
    return getattr(tfa, name + _SUFFIX[dtype])


def _ok(got, want, dtype, grad=False):
    assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        return _err(got, want) <= F32_ATOL * max(1.0, want.abs().max().item())
    return (_rel(got, want) <= BWD_RTOL) if grad else \
        _err(got, want) <= ATOL


def _full_block_round(shape, dtype, masked, seed):
    """The full-block forward, backward and delta at ``shape`` in
    ``dtype`` against their plain versions, twice to the same bits, with
    the launches on ``dtype``'s counters."""
    q, k, v = (x.float().to(dtype) for x in _qkv(shape, seed=seed))
    do = _qkv(shape, seed=seed + 1)[0].float().to(dtype)
    bias = _bias(shape[0], shape[2], seed=seed + 2, full_row=0) \
        if masked else None
    kw = dict(scale=shape[3] ** -0.5, bias=bias)
    names = ["full_block_attention", "full_block_attention_bwd",
             "full_block_attention_delta"]
    before = [_counter(n, dtype).launches for n in names]
    runs = []
    for _ in range(2):
        out, m, l = tfa._full_block_fwd(q, k, v, bias, kw["scale"],
                                        stats=True)
        runs.append((out,) + tfa.full_block_attention_bwd(q, k, v, do, out,
                                                          m, l, **kw))
    want = (tfa.full_block_attention_plain(q, k, v, **kw),) + \
        tfa.full_block_attention_bwd_plain(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert [_counter(n, dtype).launches - b
            for n, b in zip(names, before)] == [2, 2, 2]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert _ok(runs[0][0], want[0], dtype)
    for g, w in zip(runs[0][1:], want[1:]):
        assert _ok(g, w, dtype, grad=True)


def _stream_round(shape, dtype, masked, seed):
    """The streaming forward (O and LSE), delta, dQ and dK/dV at ``shape``
    in ``dtype`` against their plain versions, twice to the same bits,
    with the launches on ``dtype``'s counters."""
    q, k, v = (x.float().to(dtype) for x in _qkv(shape, seed=seed))
    do = _qkv(shape, seed=seed + 1)[0].float().to(dtype)
    bias = None
    if masked:
        bias = _bias(shape[0], shape[2], seed=seed + 2)
        bias[:, 0] = 0.0
    kw = dict(scale=shape[3] ** -0.5, bias=bias)
    names = ["stream_attention", "stream_attention_delta",
             "stream_attention_bwd_dq", "stream_attention_bwd_dkv"]
    before = [_counter(n, dtype).launches for n in names]
    runs = []
    for _ in range(2):
        out, lse = tfa.stream_attention(q, k, v, **kw)
        delta = tfa.stream_attention_delta(do, out)
        runs.append((out, lse, delta,
                     tfa.stream_attention_bwd_dq(q, k, v, do, lse, delta,
                                                 **kw),
                     *tfa.stream_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                   **kw)))
    wo, wl = tfa.stream_attention_plain(q, k, v, **kw)
    out, lse = runs[0][:2]
    want = tfa.stream_attention_bwd_plain(q, k, v, do, out, lse, **kw)
    torch.cuda.synchronize()
    assert [_counter(n, dtype).launches - b
            for n, b in zip(names, before)] == [2, 2, 2, 2]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert _ok(out, wo, dtype)
    assert _err(lse, wl) <= (F32_ATOL if dtype == torch.float32
                             else LSE_ATOL)
    assert _err(runs[0][2], tfa._delta(do, out)) <= 1e-5 * max(
        1.0, (do.float().abs() * out.float().abs()).sum(-1).max().item())
    for g, w in zip(runs[0][3:], want):
        assert _ok(g, w, dtype, grad=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("d", ODD_DIMS + (64, 128))
def test_kernels_at_any_head_dim(d, dtype):
    """Every head dim that is a multiple of 8 has a kernel: the full-block
    forward, backward and delta at (2, 4, 300, d), masked, where d <= 128;
    the streaming forward, delta, dQ and dK/dV at (2, 1, 1024, d), masked;
    in bf16, fp16 and fp32, each against its plain version on the same
    inputs, twice to the same bits."""
    _cuda_or_skip()
    assert tfa.tile_plan("stream", dtype, d) is not None
    if d <= 128:
        _full_block_round((2, 4, 300, d), dtype, True, seed=70)
    _stream_round((2, 1, 1024, d), dtype, True, seed=73)


# the main path's shapes in fp16: the flagship's full-block sites, the
# T2M / MAE head dims, the SD-VAE mid-block and the motion AE's MapConv
F16_CASES = [("full_block", (16, 16, 266, 64), False),
             ("full_block", (16, 16, 512, 64), True),
             ("full_block", (2, 16, 269, 128), False),
             ("full_block", (4, 16, 257, 32), True),
             ("stream", (17, 1, 1024, 512), False),
             ("stream", (4, 1, 1024, 640), True),
             ("stream", (1, 16, 2048, 64), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,masked", F16_CASES)
def test_f16_kernels_match_plain(kind, shape, masked):
    """The fp16 forms at the main path's shapes against their plain
    versions, counted on the ``_f16`` counters, twice to the same bits."""
    _cuda_or_skip()
    (_full_block_round if kind == "full_block" else _stream_round)(
        shape, torch.float16, masked, seed=80)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("d", [40, 64, 72])
def test_full_block_qknorm_kernel_any_head_dim(d, dtype):
    """The fused qk-norm forward off its tiles (the LayerNorm over the real
    d, the norms zero-padded to the tile) and in fp16, against its plain
    version, counted on ``dtype``'s counter."""
    _cuda_or_skip()
    shape = (2, 4, 300, d)
    q, k, v = (x.float().to(dtype) for x in _qkv(shape, seed=85))
    norms = _norms(d, seed=86)
    kw = dict(scale=d ** -0.5, bias=_bias(2, 300, seed=87))
    counter = _counter("full_block_attention_qknorm", dtype)
    before = counter.launches
    got = tfa.full_block_attention_qknorm(q, k, v, *norms, **kw)
    want = tfa.full_block_attention_qknorm_plain(q, k, v, *norms, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert _ok(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 260, 72), (2, 1, 1024, 136)])
def test_sdpa_routes_any_head_dim_and_fp16_to_the_kernels(shape, dtype):
    """``sdpa`` with a gradient at a head dim off the tiles, in each dtype:
    the route its shape picks, one forward, delta and backward launch on
    ``dtype``'s counters, ``sdpa_plain`` 0, and the plain path's values."""
    _cuda_or_skip()
    from hivae_tpu_torch.ops import attention as tattn
    q, k, v, mask = _sdpa_case(shape, True, dtype, grad=True)
    stream = shape[2] == 1024
    names = (["stream_attention", "stream_attention_delta",
              "stream_attention_bwd_dq", "stream_attention_bwd_dkv"]
             if stream else ["full_block_attention",
                             "full_block_attention_delta",
                             "full_block_attention_bwd"])
    counters = [_counter(n, dtype) for n in names] + [tattn.sdpa_plain]
    before = [c.launches for c in counters]
    assert tattn.kernel_route(q, k, v) == ("stream" if stream
                                           else "full_block")
    got = tattn.sdpa(q, k, v, key_mask=mask)
    ref = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    want = tattn._sdpa_plain(*ref, shape[3] ** -0.5, mask)
    do = torch.randn_like(got)
    grads = torch.autograd.grad(got, (q, k, v), do)
    wgrads = torch.autograd.grad(want, ref, do)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [1] * len(names) + [0]
    assert _ok(got, want.detach(), dtype)
    for g, w in zip(grads, wgrads):
        assert _ok(g, w, dtype, grad=True)


# ---------------------------------------------------------------------------
# Head dims past 640: the wide streaming kernels (csrc/attn_wide.cuh, a
# cluster of tile / 256 CTAs along D), at each wide tile and one head dim
# off each, counted on their own ``_wide`` counters; and the gradient of a
# row with no key where the JAX rule runs its full-block kernel.
# Tolerances as above.
# ---------------------------------------------------------------------------

WIDE_DIMS = (768, 1024, 1280, 1536, 1792, 2048,
             648, 776, 1032, 1288, 1544, 1800)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_stream_kernels_match_plain(d, dtype):
    """The wide forward (O, LSE), delta, dQ and dK/dV at (2, 2, 300, d),
    masked with batch 0 keyless, against their plain versions: the forward
    (the keyless row the uniform average), then the backward under the
    full-block rule (``full_block``: P = 1 / Sk on the keyless row) twice
    to the same bits, and once under the streaming one; each launch on the
    dtype's wide counters, none on the narrow ones."""
    _cuda_or_skip()
    shape = (2, 2, 300, d)
    q, k, v = (x.float().to(dtype) for x in _qkv(shape, seed=90))
    do = _qkv(shape, seed=91)[0].float().to(dtype)
    bias = _bias(2, 300, seed=92, full_row=0)
    kw = dict(scale=d ** -0.5, bias=bias)
    names = ["stream_attention", "stream_attention_delta",
             "stream_attention_bwd_dq", "stream_attention_bwd_dkv"]
    wide = [_counter(n + "_wide", dtype) for n in names]
    narrow = [_counter(n, dtype) for n in names]
    before = [c.launches for c in wide + narrow]
    runs = []
    for _ in range(2):
        out, lse = tfa.stream_attention(q, k, v, **kw)
        delta = tfa.stream_attention_delta(do, out)
        dq = tfa.stream_attention_bwd_dq(q, k, v, do, lse, delta,
                                         full_block=True, **kw)
        runs.append((out, lse, delta, dq) + tfa.stream_attention_bwd_dkv(
            q, k, v, do, lse, delta, full_block=True, **kw))
    out, lse, delta = runs[0][:3]
    streaming = (tfa.stream_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
                 *tfa.stream_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
    wo, wl = tfa.stream_attention_plain(q, k, v, **kw)
    want = tfa.stream_attention_bwd_plain(q, k, v, do, out, lse,
                                          full_block=True, **kw)
    want_s = tfa.stream_attention_bwd_plain(q, k, v, do, out, lse, **kw)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(wide + narrow, before)] == \
        [2, 2, 3, 3, 0, 0, 0, 0]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert _ok(out, wo, dtype)
    assert _ok(out[0], v[0].float().mean(dim=1, keepdim=True).expand_as(
        out[0]).to(dtype), dtype)
    assert _err(lse, wl) <= (F32_ATOL if dtype == torch.float32
                             else LSE_ATOL)
    assert _err(delta, tfa._delta(do, out)) <= 1e-5 * max(
        1.0, (do.float().abs() * out.float().abs()).sum(-1).max().item())
    for got, w in ((runs[0][3:], want), (streaming, want_s)):
        for g, x in zip(got, w):
            assert _ok(g, x, dtype, grad=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sq", [1, 65])
@pytest.mark.parametrize("sk", [1, 63, 65, 300])
@pytest.mark.parametrize("d", [1032, 1784])
def test_wide_forward_key_tails(d, sk, sq, masked, dtype):
    """The wide forward at the tails of its 64-key walked tile (Sk 1, 63,
    65, 300) with one query row and with 65 (a resident tile and one row
    of the next), clusters of 5 and 7 CTAs (whose exchange splits the 64
    rows unevenly), masked with batch 0 keyless and not: O and LSE against
    the plain version, the keyless row the uniform average, the same bits
    twice, two launches on the dtype's wide counter."""
    _cuda_or_skip()
    shape = (2, 2, sq, d)
    q, k, v = (x.float().to(dtype) for x in _qkv(shape, seed=94, sk=sk))
    bias = _bias(2, sk, seed=95, full_row=0) if masked else None
    kw = dict(scale=d ** -0.5, bias=bias)
    wide = _counter("stream_attention_wide", dtype)
    before = wide.launches
    runs = [tfa.stream_attention(q, k, v, **kw) for _ in range(2)]
    wo, wl = tfa.stream_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert wide.launches - before == 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out, lse = runs[0]
    assert _ok(out, wo, dtype)
    assert _err(lse, wl) <= (F32_ATOL if dtype == torch.float32
                             else LSE_ATOL)
    if masked:
        assert _ok(out[0], v[0].float().mean(dim=1, keepdim=True).expand_as(
            out[0]).to(dtype), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", KERNEL_DTYPES)
@pytest.mark.parametrize("shape", [(2, 2, 272, 136), (2, 2, 300, 512),
                                   (2, 2, 300, 1024), (1, 1, 2048, 136)])
def test_sdpa_keyless_row_gradient(shape, dtype):
    """A row with no key (batch 0 of the key mask all dropped) through
    ``sdpa(..., implementation="pallas")`` with a gradient. Where the JAX
    rule runs its full-block kernel and the port streams only because D is
    past 128 ((2, 2, 272, 136), (2, 2, 300, 512), (2, 2, 300, 1024)), the
    card's gradients are the autograd of the full-block plain version (the
    uniform average's; the key mask as an additive bias, as the kernels
    take it: ``_sdpa_plain``'s masked_fill would give the keyless row's q
    and k none). At (1, 1, 2048, 136), past ``full_block_fits``, the JAX
    rule streams and the card keeps the streaming kernels' rule: it equals
    the plain streaming backward."""
    _cuda_or_skip()
    from hivae_tpu_torch.ops import attention as tattn
    q, k, v, _ = _sdpa_case(shape, False, dtype, grad=True)
    mask = torch.from_numpy(
        np.random.RandomState(93).rand(shape[0], shape[2]) > 0.3).cuda()
    mask[0] = False
    do = torch.randn(shape, device="cuda").to(dtype)
    full = tattn.full_block_fits(shape, shape)
    assert tattn.kernel_route(q, k, v, "pallas") == "stream"
    assert tattn.stream_full_block(shape, shape, "pallas") == full
    got = tattn.sdpa(q, k, v, key_mask=mask, implementation="pallas")
    grads = torch.autograd.grad(got, (q, k, v), do)
    bias = torch.zeros(mask.shape, device="cuda").masked_fill(
        ~mask, tattn.MASK_NEG)
    kw = dict(scale=shape[3] ** -0.5, bias=bias)
    if full:
        ref = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        want = tfa.full_block_attention_plain(*ref, **kw)
        wgrads = torch.autograd.grad(want, ref, do)
    else:
        out, lse = tfa.stream_attention(q.detach(), k.detach(), v.detach(),
                                        **kw)
        wgrads = tfa.stream_attention_bwd_plain(q.detach(), k.detach(),
                                                v.detach(), do, out, lse,
                                                **kw)
    torch.cuda.synchronize()
    for g, w in zip(grads, wgrads):
        assert _ok(g, w, dtype, grad=True)
