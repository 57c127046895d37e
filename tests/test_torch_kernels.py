"""The port's attention kernels: plain versions vs the JAX Pallas kernels
(interpret mode on the CPU) and the ``sdpa`` dispatch rule. The CUDA
kernels themselves are held against their plain versions on the card by
``tests/test_torch_cuda.py``.

Tolerance: fp32 inputs on the CPU, so the two sides differ only by the
order of fp32 sums (atol 2e-5 on unit-scale outputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivae_tpu.ops.pallas import flash_attention as jfa
from hivae_tpu_torch.ops import attention as tattn
from hivae_tpu_torch.ops.kernels import flash_attention as tfa
from hivae_tpu_torch.ops.kernels import quant_ffn as tqf

ATOL = 2e-5


def _qkv(shape, seed=0, sk=None):
    rng = np.random.RandomState(seed)
    b, h, s, d = shape
    sk = s if sk is None else sk
    q = rng.randn(b, h, s, d).astype(np.float32)
    k = rng.randn(b, h, sk, d).astype(np.float32)
    v = rng.randn(b, h, sk, d).astype(np.float32)
    return q, k, v


def _bias(b, sk, seed=1, full_row=None):
    rng = np.random.RandomState(seed)
    keep = rng.rand(b, sk) > 0.3
    if full_row is not None:
        keep[full_row] = False
    return np.where(keep, 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("s", [260, 266])
@pytest.mark.parametrize("masked", [False, True])
def test_full_block_plain_matches_pallas(s, masked):
    q, k, v = _qkv((2, 2, s, 64), seed=s)
    bias = _bias(2, s, full_row=1) if masked else None
    scale = 64 ** -0.5
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        bias=None if bias is None else jnp.asarray(bias)))
    got = tfa.full_block_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=scale, bias=None if bias is None else torch.from_numpy(bias))
    if not masked:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    else:
        # batch 0 has keys to attend to and matches the Pallas kernel
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=ATOL,
                                   rtol=0)
        # batch 1 is fully masked: uniform over its real keys, as the
        # JAX package's XLA path gives. (The Pallas kernel averages over its
        # 16-aligned padded keys as well, zeros included: sum(v) / 272 at
        # S = 260; the port keeps the XLA path's semantics.)
        uniform = v[1].mean(axis=1, keepdims=True)
        np.testing.assert_allclose(got[1].numpy(),
                                   np.broadcast_to(uniform, got[1].shape),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_stream_plain_matches_pallas(masked):
    q, k, v = _qkv((1, 2, 640, 64), seed=7)
    bias = _bias(1, 640) if masked else None
    scale = 0.125
    jo, jl = jfa.stream_fwd_lse(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v),
                                jnp.zeros((1, 640), jnp.float32)
                                if bias is None else jnp.asarray(bias),
                                scale)
    to, tl = tfa.stream_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=scale, bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


@pytest.mark.parametrize("q_shape,k_shape", [
    ((32, 8, 260, 64), (32, 8, 260, 64)),
    ((16, 16, 266, 64), (16, 16, 266, 64)),
    ((16, 16, 512, 64), (16, 16, 512, 64)),
    ((17, 1, 1024, 512), (17, 1, 1024, 512)),
    ((1, 4, 2048, 64), (1, 4, 2048, 64)),
])
def test_full_block_fits_matches_jax(q_shape, k_shape):
    assert tattn.full_block_fits(q_shape, k_shape) == \
        jfa._full_block_fits(q_shape, k_shape)


def test_path_dispatch():
    """The serving path's shapes reach the kernels the JAX package's
    dispatch gives them: the joint/encoder attentions the full-block
    kernel, the VAE mid-block the streaming one, S = frames the plain
    path."""
    seen = []

    def spy(name):
        def fn(q, k, v, *, scale, bias=None, full_block=False):
            seen.append((name, tuple(q.shape)))
            out = torch.zeros_like(q)
            return out if name == "full" else (out, None)
        return fn

    mp = pytest.MonkeyPatch()
    mp.setattr(tfa, "full_block_attention", spy("full"))
    mp.setattr(tfa, "stream_attention", spy("stream"))
    try:
        for shape in [(32, 8, 260, 64), (16, 16, 266, 64),
                      (16, 16, 512, 64), (17, 1, 1024, 512),
                      (256, 16, 16, 64)]:
            x = torch.zeros(shape[:2] + (1, shape[3])).expand(shape)
            tattn.sdpa(x, x, x)
    finally:
        mp.undo()
    assert seen == [("full", (32, 8, 260, 64)), ("full", (16, 16, 266, 64)),
                    ("full", (16, 16, 512, 64)),
                    ("stream", (17, 1, 1024, 512))]


def test_sdpa_plain_matches_jax_with_mask_and_qknorm():
    q, k, v = _qkv((2, 3, 20, 16), seed=3)
    rng = np.random.RandomState(4)
    keep = rng.rand(2, 20) > 0.4
    keep[0] = False
    norms = [rng.randn(16).astype(np.float32) for _ in range(4)]
    from hivae_tpu.ops import attention as jattn
    want = np.asarray(jattn.sdpa(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), key_mask=jnp.asarray(keep),
                                 qk_norm=tuple(map(jnp.asarray, norms)),
                                 implementation="xla"))
    got = tattn.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), key_mask=torch.from_numpy(keep),
                     qk_norm=tuple(map(torch.from_numpy, norms)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s", [260, 300])
def test_sdpa_kernel_path_matches_jax_with_mask(s):
    """Above 256^2 logits on the CPU: the key mask travels as the -1e30
    bias into the full-block plain version."""
    q, k, v = _qkv((2, 2, s, 32), seed=s)
    keep = np.random.RandomState(5).rand(2, s) > 0.5
    keep[1] = False
    from hivae_tpu.ops import attention as jattn
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = np.array(jattn.sdpa(*args, key_mask=jnp.asarray(keep)))
    # the fully masked batch row against the XLA path (see
    # test_full_block_plain_matches_pallas)
    want[1] = np.asarray(jattn.sdpa(*args, key_mask=jnp.asarray(keep),
                                    implementation="xla"))[1]
    got = tattn.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), key_mask=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_qk_layernorm_matches_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 3, 5, 16).astype(np.float32) * 3 + 1
    g, b = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    want = np.asarray(jfa.qk_layernorm(jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(b), 1e-6))
    got = tattn.qk_layernorm(torch.from_numpy(x), torch.from_numpy(g),
                             torch.from_numpy(b), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fn", [tfa.full_block_attention,
                                tfa.stream_attention])
def test_wrapper_raises_off_cpu_without_kernel(fn):
    """A tensor that is neither on the CPU nor on a CUDA card gets no
    silent plain fallback."""
    x = torch.empty((1, 1, 300, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        fn(x, x, x, scale=0.125)
    assert fn.launches == 0


# -- the full-block kernels' launch plan and their P expression ------------

SAMPLED_S = range(257, 1041, 7)


@pytest.mark.parametrize("d", tfa.FULL_BLOCK_TILES)
def test_full_block_plan_fits_shared_memory(d):
    """Every (Sq, Sk) that ``full_block_fits`` sends to the full-block
    kernels at head dim d, sampled over S in [257, 1040], gets a plan within
    the H100's 227 KB of shared memory a block; a resident forward keeps
    one slot per key tile and leaves room for two CTAs a SM, a streaming
    one and the backward run the ``FULL_BLOCK_STAGES``-slot ring (the only
    plans the C entry points take)."""
    admitted = 0
    for sq in SAMPLED_S:
        for sk in SAMPLED_S:
            if not tattn.full_block_fits((1, 1, sq, d), (1, 1, sk, d)):
                continue
            admitted += 1
            plan = tfa._full_block_plan(sq, sk, d)
            assert plan.fwd_smem <= tfa.SMEM_PER_BLOCK
            assert plan.bwd_smem <= tfa.SMEM_PER_BLOCK
            nkt = -(-sk // tfa.FULL_BLOCK_TILE)
            if plan.resident:
                assert plan.fwd_stages == nkt
                assert plan.fwd_smem <= tfa.SMEM_TWO_PER_SM
            else:
                assert plan.fwd_stages == tfa.FULL_BLOCK_STAGES
            assert plan.bwd_stages == tfa.FULL_BLOCK_STAGES
    assert admitted > 0
    # the main path's shapes at D = 64: resident at 260/266, a ring at 512
    if d == 64:
        assert tfa._full_block_plan(266, 266, 64).resident
        assert not tfa._full_block_plan(512, 512, 64).resident


def _kernel_p(s, scale, bias):
    """The kernels' P (``attn_p`` in csrc/attn_common.cuh) emulated in
    torch: the base-2 logit t = fma(s, scale * log2 e, bias * log2 e) (the
    fused multiply-add rounded once, emulated in fp64), m = max t,
    l = sum 2^(t - m), P = 2^(t - m) * (1 / l) in fp32, rounded to bf16."""
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    sl2 = (torch.tensor(scale, dtype=torch.float32) * log2e).double()
    bl2 = (bias * log2e).double()[:, None, None, :]
    t = (s.double() * sl2 + bl2).float()
    m = t.amax(dim=-1, keepdim=True)
    e = torch.exp2(t - m)
    inv_l = 1.0 / e.sum(dim=-1, keepdim=True)
    return (e * inv_l).to(torch.bfloat16)


def test_kernel_p_matches_softmax_within_one_bf16_step():
    """The kernels' base-2 P against torch.softmax of the same fp32 logits
    rounded to bf16: at most one bf16 step apart everywhere, and the same
    bf16 value on at least 99.9% of the elements (the two differ by an ulp
    or two of fp32 before rounding). Under the -1e30 key mask, a fully
    masked row gives exactly uniform P."""
    rng = np.random.RandomState(31)
    b, h, sq, sk = 2, 3, 70, 266
    s = torch.from_numpy(3 * rng.randn(b, h, sq, sk).astype(np.float32))
    bias = torch.from_numpy(_bias(b, sk, seed=32, full_row=1))
    scale = 0.125
    got = _kernel_p(s, scale, bias)
    want = torch.softmax(s * scale + bias[:, None, None, :], dim=-1).to(
        torch.bfloat16)
    # one bf16 step: the spacing of bf16 at each value
    step = torch.nextafter(want, torch.full_like(want, float("inf"))) - want
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= step.float()).all())
    assert (got == want).float().mean().item() >= 0.999
    # batch 1 is fully masked: P = 1 / Sk on every key, bit for bit
    assert bool((got[1] == torch.tensor(1.0 / sk).to(torch.bfloat16)).all())


# -- the launch plans of the FFN-up and streaming forward kernels ----------

# (M, K, N): the int8 clip's three FFN-up shapes and every shape of the
# card tests and chip_smoke.py's checks
FFN_SHAPES = [(4256, 1024, 4096), (8192, 1024, 4096), (4096, 1024, 4096),
              (70, 128, 512), (1, 1024, 4096), (70, 1024, 4096),
              (200, 1024, 4096), (4256, 1024, 8192), (130, 256, 640)]


def _check_ffn_plan(m, k, n):
    assert tqf.supports(m, k, n)
    plan = tqf._ffn_plan(m, k, n)
    # a legal cluster: at most the portable 8 CTAs
    assert 1 <= plan.cluster <= tqf.FFN_MAX_CLUSTER
    # CTA r of the cluster owns columns [(ch * cluster + r) * cols, + cols)
    # of chunk ch: the slices tile [0, N) and no chunk lies wholly past N
    span = plan.cluster * plan.cols
    assert (plan.chunks - 1) * span < n <= plan.chunks * span
    cover = torch.zeros(plan.chunks * span, dtype=torch.int64)
    for ch in range(plan.chunks):
        for r in range(plan.cluster):
            c0 = (ch * plan.cluster + r) * plan.cols
            cover[c0:c0 + plan.cols] += 1
    assert bool((cover == 1).all())
    # N > one cluster's 8 x 512 columns is the only case with a second chunk
    assert (plan.chunks > 1) == (n > tqf.FFN_MAX_CLUSTER * tqf.FFN_COLS)
    # the ring and the static barriers, row maxima, scales and columns fit
    # one block
    assert plan.smem + tqf.FFN_STATIC <= tfa.SMEM_PER_BLOCK
    assert plan.rows == 64 and plan.cols % tqf.LANE == 0


@pytest.mark.parametrize("m,k,n", FFN_SHAPES)
def test_ffn_plan_covers_n(m, k, n):
    """The FFN-up's launch plan at each shape the port runs or checks: a
    legal cluster, column slices that cover N exactly once, and shared
    memory within one block's 227 KB."""
    _check_ffn_plan(m, k, n)


def test_ffn_plan_covers_every_admitted_n():
    """The same at every N that ``supports`` admits up to 4 clusters wide
    (N a multiple of 128 up to 16384), at K 1024."""
    for n in range(128, 16384 + 1, 128):
        _check_ffn_plan(64, 1024, n)


def _check_wide_plan(plan, d, elem, bwd):
    """A wide kernel's plan at tile d: a cluster of d / 256 CTAs (at most
    the portable 8) of 256 columns and 64 rows, two slots of the walked
    tile its source states, within one block's 232,448 bytes."""
    assert plan == tfa.WidePlan(
        cluster=d // 256, cols=256, rows=64,
        tile=(16 if elem == 4 else 32) if bwd else 32, stages=2,
        smem=tfa._wide_smem(elem, bwd))
    assert 3 <= plan.cluster <= tfa.WIDE_MAX_CLUSTER == 8
    assert plan.cols * plan.cluster == d
    assert plan.smem <= tfa.SMEM_PER_BLOCK


@pytest.mark.parametrize("d", tfa.STREAM_TILES)
def test_stream_plan_fits_shared_memory(d):
    """The streaming forward's plan at each head dim: the swizzled Q tile,
    ring slots of one swizzled 64-key tile (32 keys at D 640, where a 64-key
    slot would leave room for one) and its bias row, and the static P tile
    within one block's 227 KB, at least two slots (one landing while one
    computes), and no room left for another slot below the cap; past D 640
    the wide forward's cluster plan."""
    plan = tfa._stream_plan(d)
    if d > tfa.STREAM_NARROW_MAX:
        _check_wide_plan(plan, d, 2, bwd=False)
        return
    assert plan.tile == (32 if d == 640 else tfa.STREAM_TILE)
    q_bytes = tfa._sw128_bytes(d, tfa.STREAM_ROWS)
    slot = -(-(tfa._sw128_bytes(d, plan.tile) + 4 * plan.tile)
             // 1024) * 1024
    assert plan.smem == 1024 + q_bytes + plan.stages * slot
    # plus the static mbarriers, P tile and row partials
    assert plan.smem + tfa.STREAM_STATIC <= tfa.SMEM_PER_BLOCK
    assert 2 <= plan.stages <= tfa.STREAM_MAX_STAGES
    assert (plan.stages == tfa.STREAM_MAX_STAGES
            or plan.smem + tfa.STREAM_STATIC + slot > tfa.SMEM_PER_BLOCK)


def _stream_kernel_lse(s, scale, bias):
    """The streaming kernel's LSE emulated in torch: natural-unit logits
    t = fma(s, scale, bias) (rounded once, emulated in fp64), m = max t,
    l = sum 2^((t - m) log2 e), LSE = m + log(l) in fp32."""
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    t = (s.double() * torch.tensor(scale, dtype=torch.float32).double()
         + bias.double()[:, None, None, :]).float()
    m = t.amax(dim=-1, keepdim=True)
    l = torch.exp2((t - m) * log2e).sum(dim=-1, keepdim=True)
    return m + torch.log(l)


def test_stream_kernel_lse_matches_plain():
    """The streaming kernel's softmax form gives the plain version's LSE to
    within the card's tolerance (1e-3), and on a fully masked key row (bias
    -1e30 on every key) exactly: m stays -1e30, every p is 1."""
    b, h, sq, sk, d = 2, 2, 40, 300, 64
    q, k, v = (torch.from_numpy(x) for x in _qkv((b, h, sq, d), seed=42,
                                                    sk=sk))
    bias = torch.from_numpy(_bias(b, sk, seed=43, full_row=1))
    scale = d ** -0.5
    s = torch.matmul(q, k.transpose(-1, -2))
    got = _stream_kernel_lse(s, scale, bias)
    _, want = tfa.stream_attention_plain(q, k, v, scale=scale, bias=bias)
    assert (got - want).abs().max().item() <= 1e-3
    assert torch.equal(got[1], want[1])


# -- the sdpa gate, the streaming backward's plan, small-M int8 ------------

# (kernel, shape) above 256^2 logits that each kernel takes: the
# full-block kernel's tiles at the object encoder's S, the streaming
# kernel's past ``full_block_fits``
ROUTED = ([("full_block", (2, 4, 260, d)) for d in tfa.FULL_BLOCK_TILES]
          + [("stream", (1, 4, 2048, 64))]
          + [("stream", (2, 1, 1024, d)) for d in (128, 256, 512)])


@pytest.mark.parametrize("kind,shape", ROUTED)
def test_kernel_route_off_the_cpu(kind, shape):
    """On a tensor off the CPU (``meta`` stands in for the card) the gate
    sends bf16, fp16 and fp32 to the kernel ``full_block_fits`` picks, with
    a gradient or without (each kernel has an fp16 form and an fp32
    sibling, backward kernels included), at every head dim that kernel
    takes; the same call at D 2056, past every kernel's tiles, goes to the
    plain path; a layout the kernel does not read (a strided last dim)
    still goes to the kernel, whose wrapper copies it to its layout."""
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for d, want in ((shape[3], kind), (2056, "plain")):
            x = torch.empty(shape[:3] + (d,), device="meta", dtype=dtype)
            assert tattn.kernel_route(x, x, x) == want
            assert tfa.takes(kind, x, x, x) == (want == kind)
            g = x.requires_grad_()
            assert tattn.kernel_route(g, g, g) == want
            with torch.no_grad():
                assert tattn.kernel_route(g, g, g) == want
    wide = torch.empty(shape[:3] + (2 * shape[3],), device="meta",
                       dtype=torch.bfloat16)[..., ::2]
    assert tattn.kernel_route(wide, wide, wide) == kind
    assert tfa.kernel_layout(wide).stride(-1) == 1


def test_kernel_route_head_dim_and_cpu():
    """Off the CPU, bf16 at D = 80, S = 260 (off the tiles) goes to the
    full-block kernels (on their 96 tile), at D = 200 to the streaming ones
    (past the full-block tiles), and at D = 2056 (past every tile) plain; on
    the CPU the routes stay the dispatch rule's (the kernels' plain
    versions take any dtype and head dim), and up to 256^2 logits every
    tensor goes plain."""
    for d, want in ((80, "full_block"), (200, "stream"), (2056, "plain")):
        x = torch.empty((2, 4, 260, d), device="meta", dtype=torch.bfloat16)
        assert tattn.kernel_route(x, x, x) == want, d
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for shape, want in [((2, 4, 260, 80), "full_block"),
                            ((17, 1, 1024, 512), "stream"),
                            ((1, 2, 300, 48), "full_block"),
                            ((2, 4, 260, 648), "stream"),
                            ((256, 16, 16, 64), "plain"),
                            ((2, 4, 260, 20), "plain")]:
            y = torch.zeros(shape[:2] + (1, shape[3]), dtype=dtype
                            ).expand(shape)
            assert tattn.kernel_route(y, y, y) == want, (shape, dtype)


def test_sdpa_counts_the_calls_no_kernel_takes():
    """Off the CPU, a call above 256^2 logits that no kernel takes (D 2056,
    past every kernel's tiles, at either kernel's shape, in fp16 and bf16)
    runs the plain path through ``sdpa_plain`` and adds one to
    ``sdpa_plain.launches``; a call the size rule sends to the plain path,
    and any call on the CPU, adds nothing."""
    cases = [((2, 4, 260, 2056), torch.float16, 1),
             ((2, 1, 1024, 2056), torch.float16, 1),
             ((2, 4, 260, 2056), torch.bfloat16, 1),
             ((256, 16, 16, 64), torch.float32, 0)]
    for shape, dtype, counted in cases:
        x = torch.empty(shape, device="meta", dtype=dtype)
        mask = torch.empty(shape[:1] + shape[2:3], device="meta",
                           dtype=torch.bool)
        n = tattn.sdpa_plain.launches
        out = tattn.sdpa(x, x, x, key_mask=mask)
        assert out.shape == shape and out.dtype == dtype
        assert tattn.sdpa_plain.launches == n + counted, (shape, dtype)
    x = torch.zeros((1, 2, 300, 48))
    n = tattn.sdpa_plain.launches
    tattn.sdpa(x, x, x)
    assert tattn.sdpa_plain.launches == n


@pytest.mark.parametrize("d", tfa.STREAM_TILES)
def test_stream_bwd_plan_fits_shared_memory(d):
    """The streaming backward's plan at each head dim: 128 rows a CTA (64
    a warpgroup) below D = 256, 64 shared by roles from there, a cluster
    of 2 along D from D = 512, each CTA's columns at most 320 (5 blocks of
    64: 160 accumulator registers a thread); two resident swizzled tiles,
    ring slots of two walked 64-row ones (32-row at D 640), with the roles
    one fp32 64 x tile tile a cluster CTA, and the static mbarriers and
    rows within one block's 232,448 bytes, with at least two slots (one
    landing while one computes); past D 640 the wide dQ's and dK/dV's
    cluster plan."""
    plan = tfa._stream_bwd_plan(d)
    if d > tfa.STREAM_NARROW_MAX:
        _check_wide_plan(plan, d, 2, bwd=True)
        return
    assert plan.rows == (64 if d >= 256 else 128)
    assert plan.cluster == (2 if d >= 512 else 1)
    assert plan.cols * plan.cluster == d and plan.cols <= 320
    assert plan.cols % 64 == 0
    assert plan.tile == (32 if d == 640 else tfa.STREAM_BWD_TILE)
    tile = tfa._sw128_bytes(plan.cols, plan.tile)
    fp32 = plan.cluster * 64 * plan.tile * 4 if d >= 256 else 0
    assert plan.smem == (1024 + 2 * tfa._sw128_bytes(plan.cols, plan.rows)
                         + 2 * plan.stages * tile + fp32)
    assert plan.smem + tfa.STREAM_BWD_STATIC <= tfa.SMEM_PER_BLOCK == 232_448
    assert plan.stages >= 2


@pytest.mark.parametrize("m", [1, 16, 17, 200])
def test_int8_mm_is_exact_at_any_row_count(m):
    """``int8_mm`` equals the exact int32 product at M 1, 16 (padded to 17
    rows for torch._int_mm), 17 and 200."""
    rng = np.random.RandomState(m)
    a = torch.from_numpy(rng.randint(-127, 128, (m, 256)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (384, 256)).astype(np.int8))
    got = tqf.int8_mm(a, w)
    assert got.dtype == torch.int32 and got.shape == (m, 384)
    assert torch.equal(got, a.int() @ w.int().t())
