"""The fp32 attention kernels with a gradient, on the CPU: their arithmetic,
their launch plans and the dtypes their gate takes. The CUDA kernels
themselves are held against their fp32 plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 2.

The arithmetic: a CPU model of each fp32 backward built from
``tf32_matmul`` in the kernels' product order (three TF32 products of a
hi/lo split a matmul; the score products' small terms beside the hi.hi
sum, over the plan's k slices of the head dim, summed in order) and
accumulation chunking (each walked tile's gradient product a fresh sum,
added in tile order in fp32), against an fp64 reference. Gate: the card's,
1e-5 x max(1, max|reference|); a model with one TF32 product a matmul
must miss it."""

import numpy as np
import pytest
import torch

from hivae_tpu_torch.ops.kernels import flash_attention as tfa

F32_ATOL = 1e-5
LOG2E = 1.4426950408889634


def _inputs(shape, sk, seed, masked):
    rng = np.random.RandomState(seed)
    b, h, sq, d = shape
    q, do = (torch.from_numpy(rng.randn(b, h, sq, d).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, h, sk, d).astype(np.float32))
            for _ in range(2))
    bias = None
    if masked:
        keep = rng.rand(b, sk) > 0.3
        keep[:, 0] = True
        bias = torch.from_numpy(np.where(keep, 0.0, -1e30).astype(np.float32))
    return q, k, v, do, bias


def _scores(a, b, products, split):
    """a.b^T over the head dim in ``split`` slices, each slice's three TF32
    products (small terms and hi.hi: ``tf32_matmul``), the slices summed in
    order (the kernels' score products, ``fg_split``)."""
    n = a.shape[-1] // split
    out = None
    for i in range(split):
        part = tfa.tf32_matmul(a[..., i * n:(i + 1) * n],
                               b[..., i * n:(i + 1) * n].transpose(-1, -2),
                               products)
        out = part if out is None else out + part
    return out


def _walked(a, b, tile, products):
    """a.b over a's last dim in walked tiles of ``tile`` rows, each tile's
    product into a fresh sum added to the running one in fp32 (the
    kernels' gradient and output products)."""
    out = None
    for i in range(0, a.shape[-1], tile):
        part = tfa.tf32_matmul(a[..., i:i + tile], b[..., i:i + tile, :],
                               products)
        out = part if out is None else out + part
    return out


def _full_block_model(q, k, v, do, scale, bias, products):
    """(dq, dk, dv) as the fp32 full-block kernels form them on TF32
    wgmma: the forward's one pass (score products over the whole head dim,
    base-2 row max m and denominator l, P~ = 2^(t - m) times V over its
    ``tile``-key tiles, O = P~.V * (1 / l)), delta = rowsum(dO * O); the
    backward's score products over ``d_split`` slices of the head dim
    summed in order, P = 2^(t - m) * (1 / l), dS = P (dP - delta), the dQ
    CTA's sums over ``bwd_tile``-key tiles and the dK/dV CTA's over
    ``bwd_tile``-row query tiles (``_full_block_f32_plan``)."""
    plan = tfa._full_block_f32_plan(q.shape[-1])
    bl2 = 0.0 if bias is None else (bias * LOG2E)[:, None, None, :]
    t = _scores(q, k, products, 1) * (scale * LOG2E) + bl2
    m = t.amax(-1, keepdim=True)
    e = torch.exp2(t - m)
    inv_l = 1.0 / e.sum(-1, keepdim=True)
    out = _walked(e, v, plan.tile, products) * inv_l
    delta = (do * out).sum(-1, keepdim=True)
    tb = _scores(q, k, products, plan.d_split) * (scale * LOG2E) + bl2
    p = torch.exp2(tb - m) * inv_l
    ds = p * (_scores(do, v, products, plan.d_split) - delta)
    dq = _walked(ds, k, plan.bwd_tile, products) * scale
    dk = _walked(ds.transpose(-1, -2), q, plan.bwd_tile, products) * scale
    dv = _walked(p.transpose(-1, -2), do, plan.bwd_tile, products)
    return dq, dk, dv


def _stream_model(q, k, v, do, scale, bias, products):
    """(dq, dk, dv) as the fp32 streaming kernels form them: the fp32
    forward's natural-log LSE and output, P = exp(s * scale + bias - lse),
    dS = P (dP - delta), the score products over the dQ and dK/dV plans' k
    slices (from D 512 the cluster's column slices, one a CTA, added in
    rank order) and the gradient sums over their walked tiles
    (``_stream_bwd_f32_plan``)."""
    plan = tfa._stream_bwd_f32_plan(q.shape[-1])
    b = 0.0 if bias is None else bias[:, None, None, :]
    logits = {side: _scores(q, k, products, sp.split) * scale + b
              for side, sp in (("dq", plan.dq), ("dkv", plan.dkv))}
    m = logits["dq"].amax(-1, keepdim=True)
    e = torch.exp(logits["dq"] - m)
    lse = m + torch.log(e.sum(-1, keepdim=True))
    out = _walked(e, v, 16, products) / e.sum(-1, keepdim=True)
    delta = (do * out).sum(-1, keepdim=True)
    p = {side: torch.exp(x - lse) for side, x in logits.items()}
    ds = {side: p[side] * (_scores(do, v, products, sp.split) - delta)
          for side, sp in (("dq", plan.dq), ("dkv", plan.dkv))}
    dq = _walked(ds["dq"], k, plan.dq.tile, products) * scale
    dk = _walked(ds["dkv"].transpose(-1, -2), q, plan.dkv.tile,
                 products) * scale
    dv = _walked(p["dkv"].transpose(-1, -2), do, plan.dkv.tile, products)
    return dq, dk, dv


def _reference(kind, q, k, v, do, scale, bias):
    q, k, v, do = (x.double() for x in (q, k, v, do))
    bias = None if bias is None else bias.double()
    if kind == "full_block":
        return tfa.full_block_attention_bwd_plain(q, k, v, do, scale=scale,
                                                  bias=bias)
    out, lse = tfa.stream_attention_plain(q, k, v, scale=scale, bias=bias)
    return tfa.stream_attention_bwd_plain(q, k, v, do, out, lse, scale=scale,
                                          bias=bias)


def _errors(got, want):
    return [((g.double() - w).abs().max().item(),
             F32_ATOL * max(1.0, w.abs().max().item()))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("kind,shape,sk,masked", [
    # a flagship joint block's head dim, a ragged last tile and a mask
    ("full_block", (1, 2, 160, 64), 150, True),
    # the T2M joint block's: the warpgroups split the head dim
    ("full_block", (1, 2, 70, 128), 90, True),
    # the SD-VAE mid-block's head dim: a cluster of 2 slices of 256
    # columns, 16-row walked tiles
    ("stream", (1, 1, 256, 512), 256, False),
    # the CNN motion AE's: a cluster of 4 slices of 160 columns, 32-row
    # walked tiles, ragged against the 64-row blocks
    ("stream", (1, 1, 100, 640), 77, True),
])
def test_f32_bwd_model_meets_the_fp32_gate(kind, shape, sk, masked):
    """Why the fp32 backward kernels take three TF32 products a matmul:
    with the kernels' split and sums, dq, dk and dv are within the fp32
    gate of an fp64 reference; with one TF32 product they are not."""
    q, k, v, do, bias = _inputs(shape, sk, seed=sum(shape), masked=masked)
    scale = shape[3] ** -0.5
    want = _reference(kind, q, k, v, do, scale, bias)
    model = _full_block_model if kind == "full_block" else _stream_model
    three = _errors(model(q, k, v, do, scale, bias, 3), want)
    one = _errors(model(q, k, v, do, scale, bias, 1), want)
    assert all(err <= gate for err, gate in three), three
    assert any(err > gate for err, gate in one), one


# (query rows a CTA, keys a tile, split buffers, shared bytes) of the fp32
# forward and (resident rows a CTA, walked rows a tile, warpgroups sharing
# the head dim, shared bytes) of the fp32 backward by head dim, as the
# sources' notes state them (FF32, FB32)
FULL_BLOCK_F32 = {32: ((128, 64, 2, 116480), (128, 32, 1, 100096)),
                  64: ((128, 64, 2, 231168), (128, 32, 1, 198400)),
                  96: ((128, 32, 2, 222592), (64, 32, 2, 231168)),
                  128: ((128, 32, 1, 230656), (64, 16, 2, 214400))}


@pytest.mark.parametrize("d", tfa.FULL_BLOCK_TILES)
def test_full_block_f32_plan_fits_a_block(d):
    """The fp32 full-block plan at every full-block head dim. The forward:
    two warpgroups of 64 query rows against tiles of 64 keys at d <= 64,
    else 32; two split buffers (the next tile split while this one's P.V
    runs) where they fit beside Q, one at d 128, where a second would not;
    one raw tile; Q's, K's and V^T's hi and lo parts whole swizzle atoms.
    The backward: two warpgroups of 64 resident rows each at d <= 64; from
    d 96, where 128 rows' hi and lo parts would not fit, 64 rows shared by
    both warpgroups, which split the head dim; walked tiles of 32 rows, 16
    at d 128, where 32 would not fit; the raw resident pair within the
    split region it lands in. Each within one block's shared memory, the
    registers of the accumulators, fragments and staged loads at most 208
    a thread of the 255 one may hold."""
    plan = tfa._full_block_f32_plan(d)
    fwd, bwd = FULL_BLOCK_F32[d]
    assert (plan.rows, plan.tile, plan.splits, plan.fwd_smem) == fwd
    assert (plan.bwd_rows, plan.bwd_tile, plan.d_split, plan.bwd_smem) == bwd
    assert max(plan.fwd_smem, plan.bwd_smem) <= tfa.SMEM_PER_BLOCK
    if plan.splits == 1:
        assert tfa._full_block_f32_fwd_smem(d, plan.rows, plan.tile, 2) > \
            tfa.SMEM_PER_BLOCK
    if plan.d_split == 2:
        assert tfa._full_block_f32_bwd_smem(d, 128, plan.bwd_tile, 1) > \
            tfa.SMEM_PER_BLOCK
    if plan.bwd_tile < 32:
        assert tfa._full_block_f32_bwd_smem(d, plan.bwd_rows, 32,
                                            plan.d_split) > \
            tfa.SMEM_PER_BLOCK
    assert plan.bwd_rows * plan.d_split == 128
    # the forward's raw Q tile lands in the split buffers, the backward's
    # raw resident pair in the split region
    assert plan.rows * d * 4 <= plan.splits * 4 * plan.tile * d * 4
    assert 2 * plan.bwd_rows * d * 4 <= 4 * plan.bwd_tile * d * 4 + \
        2 * d * 128 * ((2 * plan.bwd_tile + 31) // 32)
    assert (plan.tile * d * 4) % 1024 == 0 and (plan.rows * d * 4) % 1024 == 0
    assert (d // plan.d_split) % 16 == 0
    assert max(plan.fwd_regs, plan.bwd_regs) <= 208


# (dQ rows, tile, k slices), (dK/dV rows, tile, k slices) by head dim of
# the gradient CTA (attn_f32.cuh), as flash_stream_bwd.cu's note states
# them
STREAM_BWD_F32 = {64: ((64, 32, 1), (64, 32, 1)),
                  128: ((64, 32, 1), (64, 32, 1)),
                  256: ((64, 16, 1), (32, 32, 1))}
# (cluster, columns a CTA, rows, walked tile, shared bytes, dQ and dK/dV
# accumulator registers a thread) of the cluster CTA, dQ and dK/dV alike
STREAM_BWD_F32_CLUSTER = {512: (2, 256, 64, 16, 212736, 64, 128),
                          640: (4, 160, 64, 32, 218112, 40, 80)}


@pytest.mark.parametrize("d", tfa.STREAM_TILES)
def test_stream_bwd_f32_plan_fits_a_block(d):
    """The fp32 streaming backward's plans at every streaming head dim.
    Below D 512, the gradient CTA's: the rows a CTA whose accumulators take
    at most 64 registers a thread, the widest walked tile that fits one
    block beside the resident pair, the slots and the partial score tiles
    (a tile of twice the rows would not), and the score products split
    over D where a tile has fewer than 8 blocks. From D 512, the cluster
    CTA's: 64 rows of D / cluster columns, the smallest cluster whose dK
    and dV accumulators take at most 128 registers a thread, and the
    widest walked tile (32 or 16 rows) that fits one block. Past D 640, the
    wide kernels' (dQ and dK/dV alike): a cluster of d / 256 CTAs of 256
    columns (rows 260 floats apart) and 64 rows (the dK and dV
    accumulators 128 registers a thread), two slots of a 16-row walked
    pair with 2 fp32 rows, two buffers of the X and Y partials and the P
    and dS tiles (rows 20 floats apart), within one block."""
    plan = tfa._stream_bwd_f32_plan(d)
    if d > tfa.STREAM_NARROW_MAX:
        assert plan.dq == plan.dkv
        p = plan.dq
        assert (p.cluster, p.cols, p.rows, p.tile, p.stages) == (
            d // 256, 256, 64, 16, 2)
        assert p.smem == (2 * 64 * 260 + 2 * 64 + 2 * (2 * 16 * 260 + 32)
                          + 4 * 64 * 16 + 2 * 64 * 20) * 4 == 227_072
        assert p.smem <= tfa.SMEM_PER_BLOCK
        assert 2 * p.rows * p.cols // tfa.F32_THREADS == 128
        return
    if d < tfa.STREAM_BWD_F32_CLUSTER_DIM:
        for grad, outputs, want in ((plan.dq, 1, STREAM_BWD_F32[d][0]),
                                    (plan.dkv, 2, STREAM_BWD_F32[d][1])):
            assert (grad.rows, grad.tile, grad.split) == want
            assert grad.smem == tfa._f32_grad_smem(d, grad.rows, grad.tile)
            assert grad.smem <= tfa.SMEM_PER_BLOCK
            if grad.tile < 32:
                assert tfa._f32_grad_smem(d, grad.rows, 2 * grad.tile) > \
                    tfa.SMEM_PER_BLOCK
            assert grad.rows * d * outputs <= 64 * tfa.F32_THREADS
            assert grad.split * (grad.rows // 16) * (grad.tile // 8) >= \
                tfa.F32_WARPS
        return
    cluster, cols, rows, tile, smem, dq_regs, dkv_regs = \
        STREAM_BWD_F32_CLUSTER[d]
    assert plan.dq == plan.dkv
    p = plan.dq
    assert (p.cluster, p.cols, p.rows, p.tile, p.stages, p.smem) == (
        cluster, cols, rows, tile, 2, smem)
    assert p.split == cluster and cols * cluster == d and cols % 32 == 0
    assert smem == tfa._f32_cluster_smem(cols, rows, tile, cluster) <= \
        tfa.SMEM_PER_BLOCK
    if tile < 32:
        assert tfa._f32_cluster_smem(cols, rows, 2 * tile, cluster) > \
            tfa.SMEM_PER_BLOCK
    assert (rows * cols // tfa.F32_THREADS,
            2 * rows * cols // tfa.F32_THREADS) == (dq_regs, dkv_regs)
    assert dkv_regs <= 128
    if cluster > 2:   # a smaller cluster would pass 128 registers
        assert 2 * rows * (d // (cluster // 2)) // tfa.F32_THREADS > 128


@pytest.mark.parametrize("kind,shape", [("full_block", (2, 4, 260, 64)),
                                        ("stream", (1, 1, 1024, 512))])
def test_gate_takes_fp32_with_a_gradient(kind, shape):
    """``takes`` (on ``meta`` tensors, which stand in for the card) and
    ``_refusal``: fp32, bf16 and fp16 with a gradient and without for both
    kinds; fp64 refused with one message, the dtypes the kernels take
    named."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = torch.empty(shape, device="meta", dtype=dtype)
        for grad in (False, True):
            assert tfa.takes(kind, x, x, x, grad=grad)
            assert tfa._refusal(kind, x, x, x, layout=False, grad=grad) \
                is None
        assert tfa.takes(kind, *(x.requires_grad_(),) * 3)
    x = torch.empty(shape, device="meta", dtype=torch.float64)
    for grad, suffix in ((False, ""), (True, " with a gradient")):
        assert not tfa.takes(kind, x, x, x, grad=grad)
        exc, msg = tfa._refusal(kind, x, x, x, layout=False, grad=grad)
        assert exc is TypeError
        assert msg == (f"the CUDA kernel takes one of bfloat16 or float16 "
                       f"or float32{suffix}, got torch.float64 (q "
                       f"torch.float64)")
