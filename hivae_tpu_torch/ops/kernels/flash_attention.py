"""Attention kernels for Hopper with their plain PyTorch versions.

The six TPU kernels of ``hivae_tpu/ops/pallas/flash_attention.py`` are
ported here as hand-written CUDA (``hivae_tpu_torch/csrc``):

* ``full_block_attention`` replaces ``_fwd_kernel`` (``_flash_fwd_impl``):
  the joint and motion-encoder attentions, S of 260-512, D = 64.
  Source note and bound: ``csrc/flash_full_block.cu``.
* ``full_block_attention_bwd`` replaces ``_bwd_kernel`` (``_flash_bwd``):
  its dQ, dK and dV in one launch (``csrc/flash_full_block_bwd.cu``),
  after ``full_block_attention_delta``, a pre-pass kernel in the same
  source that computes delta = rowsum(dO * O) and 1/l on the card.
  Both full-block kernels take a launch plan (slots of their copy ring,
  shared bytes) from ``_full_block_plan``.
* ``stream_attention`` replaces ``_stream_fwd_kernel``
  (``_stream_fwd_impl`` / ``stream_fwd_lse``): the SD-VAE mid-block
  attention, (B, 1, 1024, 512), and the CNN motion AE's ``MapConv``
  attention, (B, 1, 1024, 640), returning O and the per-row LSE, with a
  launch plan (keys a tile, ring slots, shared bytes) from
  ``_stream_plan``.
  Source note and bound: ``csrc/flash_stream.cu``.
* ``stream_attention_bwd_dq`` and ``stream_attention_bwd_dkv`` replace
  ``_stream_dq_kernel`` and ``_stream_dkv_kernel`` (``stream_bwd``), with
  a launch plan (rows a CTA, a 2-CTA cluster along D from D = 512, rows
  of a walked tile, ring slots, shared bytes) from ``_stream_bwd_plan``;
  before them
  ``stream_attention_delta``, a pre-pass kernel in the same source that
  computes delta = rowsum(dO * O), the port's own (the JAX package leaves
  it to XLA). Source note and bound: ``csrc/flash_stream_bwd.cu``.
* ``full_block_attention_qknorm`` replaces ``_fwd_kernel_qknorm``
  (``_flash_qknorm_fwd_impl``): the full-block forward on raw q and k with
  the per-head LayerNorm (``qk_layernorm``) applied to each tile inside the
  kernel (``csrc/flash_full_block.cu``, its ``QKN`` variant). Its backward
  recomputes the unfused composition, ``qk_layernorm`` then the full-block
  forward and backward kernels, as ``_flash_qknorm_vjp_bwd`` does, and
  gives gradients to q, k, v and the four norm parameters.

Every kernel has an fp32 sibling, launched for fp32 operands: the same
function with fp32 inputs and outputs and P and dS kept in fp32, as the
Pallas kernels compute it at fp32 (their casts to v's or q's dtype are then
no-ops), each product on the tensor cores as three TF32 products of a
hi/lo split (``tf32_matmul`` models it on the CPU). The streaming forward's
(``csrc/flash_stream.cu``, ``stream_fwd_f32_kernel``, plan
``_stream_f32_plan``) serves the fp32 SD-VAE's mid-block; the full-block
forward's and its ``QKN`` variant (``full_block_fwd_f32_kernel``, plan
``_full_block_f32_plan``), the full-block backward's and its delta
pre-pass (``full_block_bwd_f32_kernel``, same plan) and the streaming
backward's dQ, dK/dV and delta (``stream_bwd_*_f32_kernel``, plan
``_stream_bwd_f32_plan``) serve ``--mp no`` training, the fp32 frozen
models the head trainers run, the perceptual loss's fp32 decode and the
ring's fp32 hops. Their design: ``csrc/attn_f32.cuh``; from D = 512 the
streaming dQ and dK/dV run a cluster of 2 or 4 CTAs along D instead
(``F32ClusterPlan``, ``csrc/flash_stream_bwd.cu``'s note). Each counts its
launches apart from its bf16 sibling, in ``<wrapper>_f32.launches``
(``stream_attention_f32``, ``full_block_attention_f32``,
``full_block_attention_qknorm_f32``, ``full_block_attention_bwd_f32``,
``full_block_attention_delta_f32``, ``stream_attention_bwd_dq_f32``,
``stream_attention_bwd_dkv_f32``, ``stream_attention_delta_f32``): plain
counters, not functions; the wrapper is called with fp32 operands.

fp16 runs the bf16 kernels' own designs: each attention source is built a
second time with ``-DHV_F16`` (``_build.LIBRARIES``, ``<name>_f16``), which
makes its 16-bit element type fp16 (the ``.f16`` forms of the same
``mma.sync`` and ``wgmma`` shapes, fp16 TMA maps, P rounded to v's dtype and
dS to q's, as the Pallas kernels round them). Each fp16 form counts its
launches in ``<wrapper>_f16.launches`` (``full_block_attention_f16``, ...),
as the fp32 siblings do.

Head dims: each kernel is compiled for a few tile widths (``FULL_BLOCK_TILES``
32, 64, 96, 128; ``STREAM_TILES`` 64, 128, 256, 512, 640, then 768 to 2048
in steps of 256) and runs a call at head dim D on the smallest tile >= D
(``tile_plan``): its loads fill the columns past D with zeros and its
stores write the first D, which is exact (zero columns add nothing to
Q.K^T, dO.V^T or delta; ``scale`` stays the caller's). So every D % 8 == 0
up to 128 (full-block) or 2048 (streaming) has a kernel, in bf16, fp16 and
fp32, with a gradient or without; a call past 2048 has none (``takes``
refuses it, and ``ops.attention`` counts it in ``sdpa_plain``). The
streaming tiles past 640 run the wide kernels (``csrc/attn_wide.cuh``): a
cluster of tile / 256 CTAs along D, 256 columns each, one kernel per
element type and direction whatever the tile (``WideFwdPlan`` for the
forward, ``WidePlan`` for dQ and dK/dV), which count their launches
apart, in ``<wrapper>_wide`` (``stream_attention_wide``,
``stream_attention_delta_wide``, ``stream_attention_bwd_dq_wide``,
``stream_attention_bwd_dkv_wide``, and each with ``_f16`` and ``_f32``).

A row with no real key (the key mask drops every key): the streaming
forward returns the uniform average over the keys, as the full-block one
does, and its LSE is the mask's -1e30. The streaming backward forms P =
exp(s - lse) = 1 on every key there, as the Pallas streaming kernels do;
the full-block softmax gives 1 / Sk. ``stream_attention(full_block=True)``
(which ``ops.attention.sdpa`` passes where the JAX rule runs its full-block
kernel and the port streams only because D is past the full-block tiles)
makes the backward kernels take 1 / Sk for such a row (``KEYLESS_LSE``).

``full_block_attention``, ``full_block_attention_qknorm`` and
``stream_attention`` are differentiable: on a
CUDA tensor that requires grad they run a ``torch.autograd.Function`` whose
forward launches the forward kernel and whose backward launches the
backward kernel(s); the bias is the non-differentiable key mask and gets no
gradient, as in the JAX package. Each wrapper runs its plain version for a
tensor on the CPU (the tests; autograd differentiates it there) and
launches its kernel for a CUDA tensor, or raises; there is no fallback from
one to the other. ``<wrapper>.launches`` counts kernel launches: forward and
backward kernels have separate counters. ``takes`` says which operands a
kernel takes (dtype, shape, head dim); ``ops.attention.sdpa``'s gate asks
it, the wrappers copy an operand the kernel cannot read with
``kernel_layout``, and the launches raise with the same reasons. The
``*_bwd_plain`` functions write each backward out by hand, as the TPU
kernels compute it, so that the card and the tests can hold the backward
kernels against them.

The forward kernels are also ``torch.library`` custom ops
(``torch.ops.hivae.full_block_attention``, ``..._qknorm``,
``stream_attention``; the int8 FFN-up is ``torch.ops.hivae.ffn_up_quant``
in ``quant_ffn.py``), which is how a call that needs no gradient reaches
them: the CUDA implementation is the ``ctypes`` launch (it counts the
launch, and copies an operand the kernel cannot read with
``kernel_layout``, where it sees the real tensors), the CPU
implementation is the plain version, and the fake (``register_fake``)
gives the output's shape, dtype and strides only. So ``torch.export``
traces a model through the kernels as graph nodes (an exported program
launches them, and counts, when it runs), and a later ``torch.compile`` or
CUDA graph can see them. The ``torch.autograd.Function``s of training
launch the same kernels directly, as before.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch

from . import _build

# the dtypes every attention kernel takes, forward and backward alike: bf16
# and fp16 on the 16-bit kernels (one library each), fp32 on their fp32
# siblings
KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
# the head-dim tile widths each kind of kernel is compiled for
FULL_BLOCK_TILES = (32, 64, 96, 128)
STREAM_TILES = (64, 128, 256, 512, 640, 768, 1024, 1280, 1536, 1792, 2048)
_TILES = {"full_block": FULL_BLOCK_TILES, "stream": STREAM_TILES}
# the widest streaming tile a single CTA holds; the tiles past it run the
# wide kernels, a cluster of tile / WIDE_COLS CTAs along D
STREAM_NARROW_MAX = 640
WIDE_COLS = 256
# an LSE at or below this is a row with no real key (the -1e30 key mask on
# every key): ``KEYLESS_LSE`` in csrc/attn_common.cuh
KEYLESS_LSE = -5e29


def tile_plan(kind: str, dtype: torch.dtype, d: int) -> Optional[int]:
    """The tile width the ``kind`` kernels ("full_block" or "stream"),
    forward and backward alike, run a call at head dim ``d`` in ``dtype``
    on: the smallest of their tiles >= d (``hv::full_block_tile`` /
    ``hv::stream_tile`` in csrc/attn_common.cuh pick the same), or None
    where no kernel takes the call (a dtype other than bf16, fp16 and fp32;
    d not a positive multiple of 8, or past the widest tile)."""
    if dtype not in KERNEL_DTYPES or d <= 0 or d % 8:
        return None
    return next((t for t in _TILES[kind] if d <= t), None)


# ---------------------------------------------------------------------------
# plain versions (the semantics; the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------


def _f(x):
    """x in fp32 for the sums, or in fp64 when it is fp64 (the tests' exact
    reference)."""
    return x if x.dtype == torch.float64 else x.float()


def _logits(q, k, scale, bias):
    logits = torch.matmul(_f(q), _f(k).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + _f(bias)[:, None, None, :]
    return logits


def qk_layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """Per-head LayerNorm over the head dim with flax's fast variance
    (mean(x^2) - mean^2), fp32 statistics, output in x's dtype: the JAX
    package's ``qk_layernorm`` and ``_ln_block``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    mean2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * g.float()
    return ((xf - mean) * mul + b.float()).to(x.dtype)


def full_block_attention_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, scale: float,
                               bias: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """softmax(q.k^T * scale + bias) . v with fp32 logits and softmax, the
    normalised probabilities cast to v's dtype, fp32 accumulation."""
    p = torch.softmax(_logits(q, k, scale, bias), dim=-1).to(v.dtype)
    return torch.matmul(_f(p), _f(v)).to(q.dtype)


def full_block_attention_qknorm_plain(q, k, v, gq, bq, gk, bk, *,
                                      scale: float, eps: float = 1e-6,
                                      bias: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """``qk_layernorm`` of the raw q and k, then
    ``full_block_attention_plain``."""
    return full_block_attention_plain(qk_layernorm(q, gq, bq, eps),
                                      qk_layernorm(k, gk, bk, eps), v,
                                      scale=scale, bias=bias)


def stream_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, scale: float,
                           bias: Optional[torch.Tensor] = None,
                           full_block: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse (B, H, Sq, 1) fp32): the unnormalised exp(s - max) cast to
    v's dtype for P.V, divided by the fp32 row sum afterwards.
    ``full_block`` is ``stream_attention``'s (its backward kernels' rule for
    a row with no key), taken so that this function stands in for it: the
    forward is the same under either rule, and its autograd gives such a
    row the full-block rule's gradient."""
    logits = _logits(q, k, scale, bias)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(_f(p.to(v.dtype)), _f(v)) / denom
    return out.to(q.dtype), m + torch.log(denom)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 ``x``, modelled on the bits as the fp32
    streaming kernel rounds: the mantissa to 10 bits, ties away from zero
    (add half a TF32 unit, 0x1000, then clear the low 13 bits). For the CPU
    tests of that kernel's arithmetic; no kernel path calls it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_rz(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` read as TF32 by the tensor core: its top 19 bits (the low
    13 bits cleared)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor,
                products: int = 3) -> torch.Tensor:
    """a @ b (fp32) as the fp32 streaming kernel's tensor cores form it:
    with ``products`` 3, each operand split into hi = tf32_rna(x) and
    lo = x - hi (read as TF32: ``tf32_rz``) and the sum
    (lo.hi + hi.lo) + hi.hi; with 1, the single TF32 product hi.hi. Each
    TF32 product is exact in fp32."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    if products == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32_rz(a - a_hi), tf32_rz(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _grads_from_p(p, dp, delta, q, k, v, do, scale):
    """dq, dk, dv from fp32 P and dP: dV = P^T.dO with P cast to dO's
    dtype, dS = P * (dP - delta) cast to q's dtype, dQ = dS.K * scale,
    dK = dS^T.Q * scale, fp32 accumulation."""
    dv = torch.matmul(_f(p.to(do.dtype)).transpose(-1, -2), _f(do))
    ds = _f((p * (dp - delta)).to(q.dtype))
    dq = torch.matmul(ds, _f(k)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), _f(q)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def full_block_attention_bwd_plain(q, k, v, do, *, scale: float,
                                   bias: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of ``full_block_attention_plain`` for the output
    cotangent ``do``, as the TPU kernel computes them: P recomputed in
    fp32, dP = dO.V^T, delta = rowsum(dP * P)."""
    p = torch.softmax(_logits(q, k, scale, bias), dim=-1)
    dp = torch.matmul(_f(do), _f(v).transpose(-1, -2))
    delta = (dp * p).sum(dim=-1, keepdim=True)
    return _grads_from_p(p, dp, delta, q, k, v, do, scale)


def _stream_grads_plain(q, k, v, do, lse, delta, scale, bias,
                        full_block=False):
    """(dq, dk, dv) from a given ``lse`` and ``delta`` ((B, H, Sq) or
    (B, H, Sq, 1) fp32), as the TPU kernels compute them: P = exp(s -
    lse); with ``full_block``, a row whose LSE is at the key mask's level
    (``KEYLESS_LSE``: no real key) takes the full-block softmax's 1 / Sk."""
    stat = q.shape[:3] + (1,)
    lse = lse.reshape(stat)
    p = torch.exp(_logits(q, k, scale, bias) - lse)
    if full_block:
        p = torch.where(lse <= KEYLESS_LSE, 1.0 / k.shape[2], p)
    dp = torch.matmul(_f(do), _f(v).transpose(-1, -2))
    return _grads_from_p(p, dp, delta.reshape(stat), q, k, v, do, scale)


def stream_attention_bwd_plain(q, k, v, do, out, lse, *, scale: float,
                               bias: Optional[torch.Tensor] = None,
                               full_block: bool = False):
    """(dq, dk, dv) of ``stream_attention_plain``'s output from the
    forward's ``out`` and ``lse`` (B, H, Sq, 1), as the TPU kernels compute
    them: P = exp(s - lse), delta = rowsum(dO * O); ``full_block`` as
    ``_stream_grads_plain``'s."""
    delta = (_f(do) * _f(out)).sum(dim=-1, keepdim=True)
    return _stream_grads_plain(q, k, v, do, lse, delta, scale, bias,
                               full_block)


def stream_attention_bwd_dq_plain(q, k, v, do, lse, delta, *, scale: float,
                                  bias: Optional[torch.Tensor] = None,
                                  full_block: bool = False):
    """dq of the dQ kernel from a given ``lse`` and ``delta``."""
    return _stream_grads_plain(q, k, v, do, lse, delta, scale, bias,
                               full_block)[0]


def stream_attention_bwd_dkv_plain(q, k, v, do, lse, delta, *, scale: float,
                                   bias: Optional[torch.Tensor] = None,
                                   full_block: bool = False):
    """(dk, dv) of the dK/dV kernel from a given ``lse`` and ``delta``."""
    return _stream_grads_plain(q, k, v, do, lse, delta, scale, bias,
                               full_block)[1:]


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _refusal(kind, q, k, v, layout=True, grad=False):
    """Why the ``kind`` kernel ("full_block" or "stream") does not take q,
    k, v, as (exception type, message), or None when it does: one dtype
    among bf16, fp16 and fp32 (forward and, with ``grad``, backward kernels
    alike), (B, H, S, D) with (where ``layout``) a contiguous last dim and
    16-byte aligned rows, k and v of one shape matching q's batch, heads and
    head dim, and a tile for D (``tile_plan``: a multiple of 8 up to 128
    full-block, 2048 streaming). The device is not looked at."""
    for x in (q, k, v):
        if x.dtype not in KERNEL_DTYPES or x.dtype != q.dtype:
            names = " or ".join(str(t)[6:] for t in KERNEL_DTYPES)
            return TypeError, (f"the CUDA kernel takes one of {names}"
                               f"{' with a gradient' if grad else ''}, got "
                               f"{x.dtype} (q {q.dtype})")
        if x.dim() != 4 or (layout and not _aligned(x)):
            return ValueError, (f"want (B, H, S, D) with a contiguous last "
                                f"dim and 16-byte aligned rows, got "
                                f"{tuple(x.shape)} strides {x.stride()}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        return ValueError, (f"shape mismatch q {tuple(q.shape)} "
                            f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if tile_plan(kind, q.dtype, d) is None:
        return ValueError, (f"head dim {d}: the {kind} kernels take a "
                            f"multiple of 8 up to {_TILES[kind][-1]} (tiles "
                            f"{_TILES[kind]})")
    return None


def takes(kind: str, q: torch.Tensor, k: torch.Tensor,
          v: torch.Tensor, grad: Optional[bool] = None) -> bool:
    """True when the ``kind`` kernel ("full_block" or "stream") takes these
    operands (dtype, shape, head dim) once ``kernel_layout`` has copied
    each to a layout it reads: the condition under which its wrappers
    launch rather than raise, for a tensor on a CUDA card. ``grad``
    (default: whether autograd records the call, ``_needs_grad``) asks for
    the backward kernels too, which take the same dtypes and head dims. The
    gate of ``ops.attention.sdpa`` asks this."""
    if grad is None:
        grad = _needs_grad(q, k, v)
    return _refusal(kind, q, k, v, layout=False, grad=grad) is None


def _check(name, q, k, v, bias, kind, grad=False):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    for x in (q, k, v):
        if x.device != q.device:
            raise ValueError(f"{name}: q, k, v must share one device")
    refusal = _refusal(kind, q, k, v, grad=grad)
    if refusal is not None:
        raise refusal[0](f"{name}: {refusal[1]}")
    b = q.shape[0]
    if bias is not None and (bias.dtype != torch.float32 or
                             bias.shape != (b, k.shape[2]) or
                             not bias.is_contiguous() or
                             bias.device != q.device):
        raise ValueError(f"{name}: bias must be a contiguous (B, Sk) fp32 "
                         f"tensor on the device of q")


def _aligned(x):
    return (x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def kernel_layout(x):
    """x itself when the kernels can read it, else a contiguous copy (an
    incoming gradient or a caller's view may have any strides)."""
    return x if _aligned(x) else x.contiguous()


def _strides(*xs):
    vals = [s for x in xs for s in (x.stride()[:3] if x is not None
                                    else (0, 0, 0))]
    return ctypes.cast((ctypes.c_long * len(vals))(*vals), ctypes.c_void_p)


def _ptr(x):
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def _stream_of(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _empty_out(q):
    # (B, Sq, H, D) storage seen as (B, H, Sq, D): merging heads afterwards
    # is a view, not a copy
    b, h, sq, d = q.shape
    return torch.empty((b, sq, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _row_stats(q):
    b, h, sq, _ = q.shape
    return torch.empty((b, h, sq), dtype=torch.float32, device=q.device)


def _delta(do, out):
    """rowsum(dO * O) in fp32, contiguous (B, H, Sq)."""
    return (do.float() * out.float()).sum(dim=-1).contiguous()


def full_block_attention_delta_plain(do, out, l):
    """(delta, 1/l), each (B, H, Sq) fp32: the plain version of the
    backward's pre-pass kernel."""
    return _delta(do, out), (1.0 / l).contiguous()


# ---------------------------------------------------------------------------
# launch plans of the full-block kernels (csrc/flash_full_block*.cu)
# ---------------------------------------------------------------------------

SMEM_PER_BLOCK = 232_448     # bytes of shared memory a block may use (H100)
# per block when two blocks share an SM: 228 KB a SM, 1 KB reserved a block
SMEM_TWO_PER_SM = 233_472 // 2 - 1024
FULL_BLOCK_ROWS = 128        # query rows (forward, dQ) or keys (dK/dV) a CTA
FULL_BLOCK_TILE = 64         # rows of one tile in the copy ring
FULL_BLOCK_STAGES = 3        # slots of a streaming ring


@dataclasses.dataclass(frozen=True)
class FullBlockPlan:
    """Launch plan of the full-block forward and backward kernels.

    Forward: ``fwd_stages`` ring slots of a K tile, a V tile and a bias row
    each behind the Q tile, ``fwd_smem`` bytes in all. ``resident``: one
    slot per key tile, so K is read once for both passes (chosen where it
    still leaves room for two CTAs a SM); otherwise a ring of
    ``FULL_BLOCK_STAGES`` slots streams K in pass 1 and K and V in pass 2.
    Backward: the CTA's own two 128-row tiles and ``bwd_stages`` slots of
    two tiles and three fp32 rows, ``bwd_smem`` bytes."""
    fwd_stages: int
    resident: bool
    fwd_smem: int
    bwd_stages: int
    bwd_smem: int


def _sw128_bytes(d, rows):
    """A 128-byte-swizzled K-major tile: ceil(d / 64) blocks of rows x 128
    bytes (``sw128_bytes`` in csrc/attn_common.cuh)."""
    return -(-d // 64) * rows * 128


def _full_block_fwd_smem(d: int, stages: int) -> int:
    """Shared bytes of the forward with ``stages`` ring slots, as
    ``fb_smem_bytes`` in flash_full_block.cu: 1 KB to align the base, the
    swizzled Q tile, and slots of a swizzled K tile, a swizzled V tile and
    a bias row, each rounded up to 1 KB."""
    tile = FULL_BLOCK_TILE
    slot = 2 * _sw128_bytes(d, tile) + tile * 4
    return (1024 + _sw128_bytes(d, FULL_BLOCK_ROWS)
            + stages * (-(-slot // 1024) * 1024))


@functools.lru_cache(maxsize=None)
def _full_block_plan(sq: int, sk: int, d: int) -> FullBlockPlan:
    """The launch plan at Sq = ``sq``, Sk = ``sk``, head dim ``d``: resident
    K and V where they leave room for two CTAs a SM, else a ring of
    ``FULL_BLOCK_STAGES`` slots; the backward's layout is ``fbb_*_bytes``
    in flash_full_block_bwd.cu (rows d + 8 elements apart). ``sq`` does
    not change the plan."""
    nkt = -(-sk // FULL_BLOCK_TILE)
    resident = _full_block_fwd_smem(d, nkt) <= SMEM_TWO_PER_SM
    stages = nkt if resident else FULL_BLOCK_STAGES
    row = (d + 8) * 2
    bwd_slot = 2 * FULL_BLOCK_TILE * row + 3 * FULL_BLOCK_TILE * 4
    return FullBlockPlan(
        fwd_stages=stages, resident=resident,
        fwd_smem=_full_block_fwd_smem(d, stages),
        bwd_stages=FULL_BLOCK_STAGES,
        bwd_smem=2 * FULL_BLOCK_ROWS * row + FULL_BLOCK_STAGES * bwd_slot)


# launch plan of the streaming forward (csrc/flash_stream.cu): 64 query rows
# a CTA, K and V tiles of 64 keys (32 past D = 512, ``sf_bk``) as separate
# jobs through a ring of slots
STREAM_ROWS = 64
STREAM_TILE = 64
STREAM_TILE_WIDE = 32
STREAM_MAX_STAGES = 4
# static shared bytes of the streaming forward (``SF_STATIC``): its
# mbarriers, the bf16 P tile (64 rows of 72) and two rows of fp32 partials
STREAM_STATIC = 8 * (STREAM_MAX_STAGES + 1) + STREAM_ROWS * 72 * 2 + \
    2 * STREAM_ROWS * 4


# launch plans of the wide streaming kernels (csrc/attn_wide.cuh), the
# tiles past STREAM_NARROW_MAX: a cluster of tile / WIDE_COLS CTAs of 8
# warps, each WIDE_COLS columns of every operand for WIDE_ROWS resident rows
WIDE_ROWS = 64
WIDE_MAX_CLUSTER = 8   # the portable cluster size
WIDE_CLUSTERS = tuple(range(3, WIDE_MAX_CLUSTER + 1))
# the wide forward (``stream_fwd_wide_kernel``): walked tiles of 64 keys
# (``WF_KEYS``), K and V as separate TMA jobs through a ring of slots, and
# sets of exchange buffers, by element bytes (``wf_slots``, ``wf_bufs``)
WIDE_FWD_TILE = 64
WIDE_FWD_SLOTS = {2: 4, 4: 2}
WIDE_FWD_BUFFERS = {2: 2, 4: 1}
# the wide dQ and dK/dV (``stream_bwd_wide_kernel``): two cp.async slots of
# walked tiles of these rows, by element bytes (``swb_tile``)
WIDE_STAGES = 2
WIDE_BWD_TILE = {2: 32, 4: 16}


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """Launch plan of the wide dQ and dK/dV (``swb_smem_bytes``): a
    cluster of ``cluster`` CTAs along D, each holding ``cols`` columns of
    every operand and output for ``rows`` resident rows; ``stages`` slots
    of the walked ``tile``-row tiles (Q and dO, or K and V); ``smem``
    dynamic shared bytes."""
    cluster: int
    cols: int
    rows: int
    tile: int
    stages: int
    smem: int


def _wide_ld(elem: int) -> int:
    """Row stride, in elements, of the wide backward's shared tiles of
    ``elem``-byte elements: WIDE_COLS and 16 bytes."""
    return WIDE_COLS + 16 // elem


def _wide_smem(elem: int) -> int:
    """Shared bytes of the wide dQ and dK/dV: the resident pair and 2 fp32
    rows of it, two slots of the walked pair and 2 fp32 rows, two buffers
    of the X and Y partials, the P and dS tiles."""
    ld, r, t = _wide_ld(elem), WIDE_ROWS, WIDE_BWD_TILE[elem]
    return ((2 * r * ld + 2 * (2 * t * ld + 2 * t * 4 // elem)) * elem
            + (2 * r + 4 * r * t + 2 * r * (t + 4)) * 4)


@functools.lru_cache(maxsize=None)
def _wide_plan(d: int, elem: int) -> WidePlan:
    """The wide backward's plan at tile ``d`` (a multiple of WIDE_COLS past
    640) for ``elem``-byte operands, dQ and dK/dV alike."""
    return WidePlan(cluster=d // WIDE_COLS, cols=WIDE_COLS, rows=WIDE_ROWS,
                    tile=WIDE_BWD_TILE[elem], stages=WIDE_STAGES,
                    smem=_wide_smem(elem))


def wide_fwd_rows(cluster: int) -> Tuple[int, ...]:
    """The wide forward's exchange at ``cluster`` CTAs (``wf_row0``): CTA r
    owns rows [rows[r], rows[r + 1]) of a walked tile's WIDE_ROWS rows,
    sums their partial scores and sends their P to every CTA."""
    return tuple(WIDE_ROWS * r // cluster for r in range(cluster + 1))


def _wide_fwd_recv_rows() -> int:
    """Rows of partial scores a wide-forward owner receives, at most over
    the wide cluster sizes (``wf_recv_rows``): a slot of its rows from
    each CTA."""
    return max(c * max(b - a for a, b in zip(r, r[1:]))
               for c in WIDE_CLUSTERS for r in [wide_fwd_rows(c)])


@dataclasses.dataclass(frozen=True)
class WideFwdPlan:
    """Launch plan of the wide forward (``wf_smem_bytes`` in
    csrc/attn_wide.cuh): a cluster of ``cluster`` CTAs along D, each
    holding ``cols`` columns of Q, K, V and O for ``rows`` query rows;
    walked tiles of ``tile`` keys, K and V as separate TMA jobs through
    ``stages`` slots; ``buffers`` sets of the exchange (the partial scores
    an owner receives, P, the rows' rescale factors); ``smem`` dynamic
    shared bytes, 1 KB to align the base and the mbarriers included."""
    cluster: int
    cols: int
    rows: int
    tile: int
    stages: int
    buffers: int
    smem: int


@functools.lru_cache(maxsize=None)
def _wide_fwd_plan(d: int, elem: int) -> WideFwdPlan:
    """The wide forward's plan at tile ``d`` (a multiple of WIDE_COLS past
    640) for ``elem``-byte operands: Q and ``stages`` K or V tiles of
    WIDE_ROWS x WIDE_COLS, and per exchange buffer the received partials
    (fp32), the P tile (16-bit rows of 64 keys padded by 16 bytes; fp32
    unpadded) and the rows' fp32 rescale factors."""
    stages, buffers = WIDE_FWD_SLOTS[elem], WIDE_FWD_BUFFERS[elem]
    tile_bytes = WIDE_ROWS * WIDE_COLS * elem
    p_row = WIDE_FWD_TILE * 4 if elem == 4 else WIDE_FWD_TILE * 2 + 16
    buf = (_wide_fwd_recv_rows() * WIDE_FWD_TILE * 4 + WIDE_ROWS * p_row
           + WIDE_ROWS * 4)
    bars = stages + 2 + 2 * buffers
    return WideFwdPlan(cluster=d // WIDE_COLS, cols=WIDE_COLS, rows=WIDE_ROWS,
                       tile=WIDE_FWD_TILE, stages=stages, buffers=buffers,
                       smem=1024 + (1 + stages) * tile_bytes + buffers * buf
                       + 8 * bars)


def wide_fwd_active_clusters(dtype: torch.dtype, cluster: int) -> int:
    """How many clusters of ``cluster`` CTAs of the wide forward for
    ``dtype`` operands the card holds at once, at its plan's shared bytes
    (``hv_stream_fwd_wide_clusters``: cudaOccupancyMaxActiveClusters)."""
    lib = _build.load("flash_stream_f16" if dtype == torch.float16
                      else "flash_stream")
    fn = lib.hv_stream_fwd_wide_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    count = ctypes.c_int(0)
    rc = fn(cluster, int(dtype == torch.float32), ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"hv_stream_fwd_wide_clusters: error {rc}")
    return count.value


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Launch plan of the streaming forward: ``stages`` ring slots, each one
    128-byte-swizzled K or V tile of ``tile`` keys and a bias row, behind
    the swizzled Q tile of ``STREAM_ROWS`` rows; ``smem`` bytes in all."""
    tile: int
    stages: int
    smem: int


def _round_kb(x):
    return -(-x // 1024) * 1024


@functools.lru_cache(maxsize=None)
def _stream_plan(d: int) -> Union[StreamPlan, WideFwdPlan]:
    """The plan at head dim ``d`` (``sf_bk``, ``sf_stages`` and
    ``sf_smem_bytes`` in flash_stream.cu): tiles of ``STREAM_TILE`` keys,
    ``STREAM_TILE_WIDE`` past D = 512 (where a 64-key slot would leave room
    for one beside Q), and as many slots as fit one block's shared memory
    beside the static ``STREAM_STATIC`` bytes, at most
    ``STREAM_MAX_STAGES``; past D = 640 the wide forward's
    (``WideFwdPlan``). The sequence lengths do not change it."""
    if d > STREAM_NARROW_MAX:
        return _wide_fwd_plan(d, 2)
    tile = STREAM_TILE_WIDE if d > 512 else STREAM_TILE
    q_bytes = _sw128_bytes(d, STREAM_ROWS)
    slot = _round_kb(_sw128_bytes(d, tile) + tile * 4)
    stages = min(STREAM_MAX_STAGES,
                 (SMEM_PER_BLOCK - STREAM_STATIC - 1024 - q_bytes) // slot)
    return StreamPlan(tile=tile, stages=stages,
                      smem=1024 + q_bytes + stages * slot)


# launch plan of the fp32 streaming forward (csrc/flash_stream.cu,
# ``stream_fwd_f32_kernel``, 3xTF32 on the tensor cores): 64 query rows a
# CTA of 8 warps, K and V tiles as separate jobs through two slots, rows
# d + 4 floats apart, the exchange of partial scores (each thread's
# ``tile`` fp32 S fragment values), P and the rows' rescale factors
STREAM_F32_ROWS = 64
STREAM_F32_THREADS = 256
STREAM_F32_STAGES = 2


@dataclasses.dataclass(frozen=True)
class StreamF32Plan:
    """Launch plan of the fp32 streaming forward: ``rows`` query rows a
    CTA, ``stages`` slots of one K or V tile of ``tile`` keys, ``smem``
    dynamic shared bytes (``sf32_bk`` and ``sf32_smem_bytes``)."""
    rows: int
    tile: int
    stages: int
    smem: int


def _stream_f32_smem(d: int, tile: int) -> int:
    """Shared bytes of the fp32 plan with ``tile``-key tiles: the Q tile,
    two slots (a tile and its fp32 bias row), the exchange of partial
    scores, the tile's P and a row of fp32 rescale factors."""
    slot = (tile * (d + 4) + tile) * 4
    return (STREAM_F32_ROWS * (d + 4) * 4 + STREAM_F32_STAGES * slot
            + (STREAM_F32_THREADS + STREAM_F32_ROWS) * tile * 4
            + STREAM_F32_ROWS * 4)


@functools.lru_cache(maxsize=None)
def _stream_f32_plan(d: int) -> Union[StreamF32Plan, WideFwdPlan]:
    """The plan at head dim ``d`` (``sf32_bk``): K/V tiles of 32 keys to
    d = 256 (a wider tile's scores would take more registers than a thread
    has beside the output), 16 at 512 and 8 at 640, so that the Q tile, two
    slots, the exchange and P fit one block; past D = 640 the wide
    forward's at fp32 (``WideFwdPlan``). The sequence lengths do not
    change it."""
    if d > STREAM_NARROW_MAX:
        return _wide_fwd_plan(d, 4)
    tile = 32 if d <= 256 else 16 if d <= 512 else 8
    return StreamF32Plan(rows=STREAM_F32_ROWS, tile=tile,
                         stages=STREAM_F32_STAGES,
                         smem=_stream_f32_smem(d, tile))


# launch plan of the streaming backward (csrc/flash_stream_bwd.cu): walked
# tiles of 64 rows (32 past D = 512) through a ring of STREAM_BWD_STAGES
# slots; at D <= 128 a CTA owns 128 keys (dK/dV) or query rows (dQ), 64 a
# warpgroup; from D = 256 on it owns 64, which its two warpgroups share by
# roles (S and P; dP and dS) through an fp32 64 x tile tile, and from
# D = 512 a cluster of 2 CTAs splits the head dim
STREAM_BWD_TILE = 64
STREAM_BWD_TILE_WIDE = 32
STREAM_BWD_STAGES = 2
STREAM_BWD_SPLIT_DIM = 256
STREAM_BWD_CLUSTER_DIM = 512
# static shared bytes (the ring's and the cluster exchange's mbarriers and
# the fp32 rows of each slot: lse and delta for dK/dV, the key bias for dQ),
# the larger of the two kernels'
STREAM_BWD_STATIC = 8 * (STREAM_BWD_STAGES + 3) + \
    STREAM_BWD_STAGES * 2 * STREAM_BWD_TILE * 4


@dataclasses.dataclass(frozen=True)
class StreamBwdPlan:
    """Launch plan of the streaming backward kernels (dQ and dK/dV alike):
    ``rows`` keys or query rows a CTA; a cluster of ``cluster`` CTAs along
    D, each holding ``cols`` columns of every operand; ``stages`` ring
    slots of two walked ``tile``-row tiles; ``smem`` dynamic shared
    bytes."""
    rows: int
    cluster: int
    cols: int
    tile: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=None)
def _stream_bwd_plan(d: int) -> Union[StreamBwdPlan, WidePlan]:
    """The plan at head dim ``d`` (``sb_rows``, ``sb_cluster``, ``sb_cols``,
    ``sb_tile`` and ``sb_smem_bytes`` in flash_stream_bwd.cu): 1 KB to
    align the base, two resident swizzled tiles of ``rows`` rows,
    ``stages`` slots of two walked ones of ``tile`` rows (32 past D = 512,
    where 64 would not fit), and with the roles (d >= 256) one fp32
    64 x ``tile`` tile a cluster CTA (P; from D = 512 the exchange tiles of
    S and dP); past D = 640 the wide dQ's and dK/dV's (``WidePlan``). The
    sequence lengths do not change it."""
    if d > STREAM_NARROW_MAX:
        return _wide_plan(d, 2)
    split = d >= STREAM_BWD_SPLIT_DIM
    rows = STREAM_BWD_TILE if split else 2 * STREAM_BWD_TILE
    cluster = 2 if d >= STREAM_BWD_CLUSTER_DIM else 1
    cols = d // cluster
    tile = STREAM_BWD_TILE_WIDE if d > 512 else STREAM_BWD_TILE
    smem = (1024 + 2 * _sw128_bytes(cols, rows)
            + 2 * STREAM_BWD_STAGES * _sw128_bytes(cols, tile)
            + (cluster * STREAM_BWD_TILE * tile * 4 if split else 0))
    return StreamBwdPlan(rows=rows, cluster=cluster, cols=cols, tile=tile,
                         stages=STREAM_BWD_STAGES, smem=smem)


# launch plans of the fp32 streaming backward's gradient CTA
# (csrc/attn_f32.cuh, ``f32_grad_cta``): CTAs of 8 warps
F32_THREADS = 256
F32_WARPS = F32_THREADS // 32


@dataclasses.dataclass(frozen=True)
class F32GradPlan:
    """Launch plan of one kind of fp32 backward CTA (``fg_rows``,
    ``fg_tile``, ``fg_split`` and ``fg_smem`` in attn_f32.cuh): ``rows``
    resident rows (query rows for dQ, keys for dK/dV), walked tiles of
    ``tile`` rows, the score products split over ``split`` slices of the
    head dim, ``smem`` dynamic shared bytes; one CTA a cluster."""
    rows: int
    tile: int
    split: int
    smem: int
    cluster = 1


def _f32_split(rows: int, tile: int) -> int:
    blocks = rows // 16 * (tile // 8)
    return 1 if blocks >= F32_WARPS else F32_WARPS // blocks


def _f32_grad_smem(d: int, rows: int, tile: int) -> int:
    """Shared bytes (``fg_smem_at``): the resident pair and 3 fp32 rows,
    two slots of a walked pair and 3 fp32 rows, the X and Y partials."""
    return 4 * (2 * rows * (d + 4) + 3 * rows
                + 2 * (2 * tile * (d + 4) + 3 * tile)
                + 2 * _f32_split(rows, tile) * rows * (tile + 8))


@functools.lru_cache(maxsize=None)
def _f32_grad_plan(d: int, outputs: int) -> F32GradPlan:
    """The plan of a CTA with ``outputs`` gradients (1: dQ; 2: dK and dV)
    of head dim ``d``: 64, 32 or 16 rows, the most whose fp32 accumulators
    take at most 64 registers a thread (16 at least), then walked tiles of
    32, 16 or 8 rows, the widest that fit one block."""
    per_thread = 16384 // (d * outputs)
    rows = 64 if per_thread >= 64 else 32 if per_thread >= 32 else 16
    tile = next(t for t in (32, 16, 8)
                if _f32_grad_smem(d, rows, t) <= SMEM_PER_BLOCK)
    return F32GradPlan(rows=rows, tile=tile, split=_f32_split(rows, tile),
                       smem=_f32_grad_smem(d, rows, tile))


@dataclasses.dataclass(frozen=True)
class FullBlockF32Plan:
    """Launch plan of the fp32 full-block kernels on TF32 wgmma, operands
    split once a tile (``FF32`` in csrc/flash_full_block.cu, ``FB32`` in
    csrc/flash_full_block_bwd.cu), at head dim ``d``. The forward: ``rows``
    query rows a CTA (two warpgroups of 64) against tiles of ``tile`` keys,
    ``splits`` split K / V^T buffers (2: the next tile is split while this
    one's P.V runs), one raw tile landing by cp.async, ``fwd_smem`` bytes.
    The backward, one launch of dQ and dK/dV CTAs alike, two warpgroups
    each: ``bwd_rows`` resident rows a CTA, 64 a warpgroup, or 64 shared by
    both where ``d_split`` is 2 (each warpgroup half the head dim of the
    score products and half the output columns); walked tiles of
    ``bwd_tile`` rows, loaded into registers a tile ahead; ``bwd_smem``
    bytes."""
    d: int
    rows: int
    tile: int
    splits: int
    fwd_smem: int
    bwd_rows: int
    bwd_tile: int
    d_split: int
    bwd_smem: int

    @property
    def fwd_regs(self) -> int:
        """fp32 accumulator and fragment registers a thread at the
        forward's peak: O (d / 2), and the larger of S's two sums (tile)
        and P.V's fresh sum (d / 2) beside P~'s hi and lo (tile)."""
        return self.d // 2 + max(self.tile, self.d // 2 + self.tile)

    @property
    def bwd_regs(self) -> int:
        """The same for a dK/dV thread (the larger kind) while its
        gradient products run: dK and dV and their fresh sums (cols / 2
        each), P's and dS's hi and lo (2 x tile), and the next walked tile
        in registers (its share of 2 x tile x d floats)."""
        cols = self.d // self.d_split
        loads = -(-self.bwd_tile * self.d // 4 // 256) * 4
        return 2 * cols + 2 * self.bwd_tile + 2 * loads


def _full_block_f32_fwd_smem(d: int, rows: int, tile: int,
                             splits: int) -> int:
    """``FF32::SMEM``: from a 1024-byte aligned base, Q's hi and lo parts,
    the split buffers (K's and V^T's hi and lo), the raw K and V tiles and
    bias row, and a base-2 bias row a split buffer."""
    return (1024 + 2 * rows * d * 4 + splits * 4 * tile * d * 4
            + 2 * tile * d * 4 + tile * 4 + splits * tile * 4)


def _full_block_f32_bwd_smem(d: int, rows: int, tile: int,
                             d_split: int) -> int:
    """``FB32::SMEM``: from a 1024-byte aligned base, the resident pair's
    hi and lo parts, the walked pair's, the transposed parts (d rows of
    128-byte swizzle atoms holding 2 x tile k positions), the walked rows'
    three statistics twice (this tile's, the next as loaded), and where the
    warpgroups split d their score partials (2 warpgroups x 2 products x
    64 x tile floats)."""
    nat = tile * d * 4
    tt = d * 128 * ((2 * tile + 31) // 32)
    ex = 2 * tile * 128 * 4 if d_split == 2 else 0
    return 1024 + 4 * rows * d * 4 + 4 * nat + 2 * tt + 2 * 3 * tile * 4 \
        + ex


@functools.lru_cache(maxsize=None)
def _full_block_f32_plan(d: int) -> FullBlockF32Plan:
    """The fp32 full-block plan at head dim ``d`` (the sequence lengths do
    not change it): the forward's 128 query rows against 64-key tiles at d
    <= 64, else 32, with two split buffers where they fit (d < 128); the
    backward's 128 resident rows at d <= 64, else 64 rows shared by both
    warpgroups, walking 32-row tiles, 16 at d 128."""
    rows = 128
    tile = 64 if d <= 64 else 32
    splits = 2 if d < 128 else 1
    d_split = 1 if d <= 64 else 2
    bwd_rows, bwd_tile = 128 // d_split, 32 if d <= 96 else 16
    return FullBlockF32Plan(
        d=d, rows=rows, tile=tile, splits=splits,
        fwd_smem=_full_block_f32_fwd_smem(d, rows, tile, splits),
        bwd_rows=bwd_rows, bwd_tile=bwd_tile, d_split=d_split,
        bwd_smem=_full_block_f32_bwd_smem(d, bwd_rows, bwd_tile, d_split))


# the fp32 streaming backward from D = 512 on (csrc/flash_stream_bwd.cu,
# ``fc_cta``): a cluster of CTAs along D, each 64 rows of its columns
STREAM_BWD_F32_CLUSTER_DIM = 512
STREAM_BWD_F32_CLUSTER_ROWS = 64


@dataclasses.dataclass(frozen=True)
class F32ClusterPlan:
    """Launch plan of the fp32 streaming backward's cluster CTA
    (``fc_cluster``, ``fc_tile`` and ``fc_smem`` in flash_stream_bwd.cu):
    a cluster of ``cluster`` CTAs along D, each holding ``cols`` columns of
    every operand and output for ``rows`` resident rows; ``stages`` ring
    slots of two walked ``tile``-row tiles; ``smem`` dynamic shared bytes.
    The score products are summed over the cluster's ``split`` = cluster
    column slices in rank order."""
    cluster: int
    cols: int
    rows: int
    tile: int
    stages: int
    smem: int

    @property
    def split(self) -> int:
        return self.cluster


def _f32_cluster_smem(cols: int, rows: int, tile: int, cluster: int) -> int:
    """Shared bytes (``fc_smem_at``): the resident pair (rows cols + 4
    floats apart) and 2 fp32 rows, two slots of a walked pair and 2 fp32
    rows of tile, and a slot for each peer's X and Y partials (2 x rows x
    tile), which the P and dS tiles (rows tile + 8 apart) overwrite."""
    return 4 * (2 * rows * (cols + 4) + 2 * rows
                + 2 * (2 * tile * (cols + 4) + 2 * tile)
                + max((cluster - 1) * 2 * rows * tile,
                      2 * rows * (tile + 8)))


@functools.lru_cache(maxsize=None)
def _f32_cluster_plan(d: int) -> F32ClusterPlan:
    """The cluster plan at head dim ``d`` >= 512, dQ and dK/dV alike: 2 CTAs
    where each CTA's d / 2 columns are a multiple of 32 and at most 256
    (the dK and dV accumulators of 64 rows in at most 128 registers a
    thread), else 4; walked tiles of 32 rows, or 16 where 32 would not fit
    one block."""
    rows = STREAM_BWD_F32_CLUSTER_ROWS
    cluster = 2 if (d // 2) % 32 == 0 and d // 2 <= 256 else 4
    cols = d // cluster
    tile = next(t for t in (32, 16)
                if _f32_cluster_smem(cols, rows, t, cluster) <= SMEM_PER_BLOCK)
    return F32ClusterPlan(cluster=cluster, cols=cols, rows=rows, tile=tile,
                          stages=2,
                          smem=_f32_cluster_smem(cols, rows, tile, cluster))


@dataclasses.dataclass(frozen=True)
class StreamBwdF32Plan:
    """Launch plans of the fp32 streaming dQ and dK/dV kernels: the
    gradient CTA's (``F32GradPlan``, one CTA a cluster) below D = 512, the
    cluster CTA's (``F32ClusterPlan``) at 512 and 640, the wide kernel's
    (``WidePlan``) past 640."""
    dq: Union[F32GradPlan, F32ClusterPlan, WidePlan]
    dkv: Union[F32GradPlan, F32ClusterPlan, WidePlan]


@functools.lru_cache(maxsize=None)
def _stream_bwd_f32_plan(d: int) -> StreamBwdF32Plan:
    if d > STREAM_NARROW_MAX:
        plan = _wide_plan(d, 4)
        return StreamBwdF32Plan(dq=plan, dkv=plan)
    if d >= STREAM_BWD_F32_CLUSTER_DIM:
        plan = _f32_cluster_plan(d)
        return StreamBwdF32Plan(dq=plan, dkv=plan)
    return StreamBwdF32Plan(dq=_f32_grad_plan(d, 1),
                            dkv=_f32_grad_plan(d, 2))


def _fn(lib_name, sym, n_ptr, n_int, n_float=1):
    """The C entry point ``sym`` of library ``lib_name`` (``_build.LIBRARIES``:
    ``csrc/<source>.cu``, built as is or with -DHV_F16; n_ptr pointers,
    n_int ints, n_float floats (the scale, ...), the strides and the stream)
    and the library's error-string function
    ``hv_<source less "flash_">_error_string``."""
    lib = _build.load(lib_name)
    fn = getattr(lib, sym)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_float] * n_float + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    source = _build.LIBRARIES[lib_name][0]
    err = getattr(lib, f"hv_{source[6:]}_error_string")
    err.restype = ctypes.c_char_p
    return fn, err


# each entry point: (source, symbol, pointers, ints, floats); a 16-bit entry
# point is looked up in the fp16 library for fp16 operands
_ENTRIES = {
    "full_block": ("flash_full_block", "hv_full_block_fwd", 8, 8, 2),
    "full_block_bwd": ("flash_full_block_bwd", "hv_full_block_bwd", 11, 7, 1),
    "full_block_delta": ("flash_full_block_bwd", "hv_full_block_delta", 5, 4,
                         0),
    "stream": ("flash_stream", "hv_stream_fwd", 6, 7, 1),
    "stream_dq": ("flash_stream_bwd", "hv_stream_bwd_dq", 8, 9, 1),
    "stream_dkv": ("flash_stream_bwd", "hv_stream_bwd_dkv", 9, 9, 1),
    "stream_delta": ("flash_stream_bwd", "hv_stream_delta", 3, 4, 0),
    "full_block_f32": ("flash_full_block", "hv_full_block_fwd_f32", 8, 8, 2),
    "full_block_bwd_f32": ("flash_full_block_bwd", "hv_full_block_bwd_f32",
                           11, 9, 1),
    "full_block_delta_f32": ("flash_full_block_bwd",
                             "hv_full_block_delta_f32", 5, 4, 0),
    "stream_f32": ("flash_stream", "hv_stream_fwd_f32", 6, 7, 1),
    "stream_dq_f32": ("flash_stream_bwd", "hv_stream_bwd_dq_f32", 8, 10, 1),
    "stream_dkv_f32": ("flash_stream_bwd", "hv_stream_bwd_dkv_f32", 9, 10,
                       1),
    "stream_delta_f32": ("flash_stream_bwd", "hv_stream_delta_f32", 3, 4, 0),
}


@functools.lru_cache(maxsize=None)
def _entry(name: str, dtype: torch.dtype):
    """(entry point, error-string function) of ``_ENTRIES[name]`` for
    operands of ``dtype``: the fp32 one (``<name>_f32``) for fp32, the
    16-bit one from the bf16 library or, for fp16, the fp16 library."""
    if dtype == torch.float32:
        name += "_f32"
    source, sym, n_ptr, n_int, n_float = _ENTRIES[name]
    lib = source + "_f16" if dtype == torch.float16 else source
    return _fn(lib, sym, n_ptr, n_int, n_float)


def _f32(x):
    return x.dtype == torch.float32


def _count(wrapper, x, wide=False):
    """One launch more on ``wrapper``'s counter (bf16 operands), or on its
    fp32 or fp16 sibling's (``<name>_f32``, ``<name>_f16``); a wide
    kernel's (a tile past ``STREAM_NARROW_MAX``) on ``<name>_wide`` and its
    siblings (``<name>_wide_f32``, ``<name>_wide_f16``)."""
    name = wrapper.__name__ + ("_wide" if wide else "") + {
        torch.float32: "_f32", torch.float16: "_f16"}.get(x.dtype, "")
    (wrapper if name == wrapper.__name__ else globals()[name]).launches += 1


def _wide(d, dtype):
    """Whether head dim ``d`` runs a wide streaming kernel."""
    return tile_plan("stream", dtype, d) > STREAM_NARROW_MAX


def _launch(name, fn_err, *args):
    fn, err_str = fn_err
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err_str(rc).decode()}")


def _launch_full_block(name, q, k, v, bias, norms, m, l, scale, eps):
    """One launch of the forward kernel under ``_full_block_plan`` (bf16,
    fp16) or ``_full_block_f32_plan`` (fp32) at the head dim's tile -> out;
    ``norms`` is None or the packed (4, tile) qk-norm parameters."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    tile = tile_plan("full_block", q.dtype, d)
    if _f32(q):
        plan = _full_block_f32_plan(tile)
        plan_args = (plan.rows, plan.tile, plan.fwd_smem)
    else:
        plan = _full_block_plan(sq, sk, tile)
        plan_args = (plan.fwd_stages, int(plan.resident), plan.fwd_smem)
    fn = _entry("full_block", q.dtype)
    out = _empty_out(q)
    _launch(name, fn, _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(norms),
            _ptr(out), _ptr(m), _ptr(l), b, h, sq, sk, d, *plan_args,
            float(scale), float(eps), _strides(q, k, v, out), _stream_of(q))
    return out


def _full_block_fwd(q, k, v, bias, scale, stats):
    """Forward launch -> (out, m, l); m and l (the row max of the base-2
    logits and the softmax denominator, (B, H, Sq) fp32, the backward
    kernel's inputs) only when ``stats``, else None."""
    _check("full_block_attention", q, k, v, bias, "full_block")
    m, l = (_row_stats(q), _row_stats(q)) if stats else (None, None)
    out = _launch_full_block("full_block_attention", q, k, v, bias, None, m,
                             l, scale, 0.0)
    _count(full_block_attention, q)
    return out, m, l


def _full_block_qknorm_fwd(q, k, v, norms, bias, scale, eps):
    """qk-norm forward launch -> out; ``norms`` = (gq, bq, gk, bk), packed
    as fp32 (4, tile) rows zero-padded past D (the kernel's LayerNorm keeps
    the padded columns zero and averages over D)."""
    _check("full_block_attention_qknorm", q, k, v, bias, "full_block")
    d = q.shape[3]
    for x in norms:
        if x.shape != (d,) or x.device != q.device:
            raise ValueError(f"full_block_attention_qknorm: norm parameters "
                             f"must be ({d},) on {q.device}, got "
                             f"{tuple(x.shape)} on {x.device}")
    tile = tile_plan("full_block", q.dtype, d)
    packed = torch.zeros((4, tile), dtype=torch.float32, device=q.device)
    packed[:, :d] = torch.stack([x.detach().float() for x in norms])
    out = _launch_full_block("full_block_attention_qknorm", q, k, v, bias,
                             packed, None, None, scale, eps)
    _count(full_block_attention_qknorm, q)
    return out


def full_block_attention_delta(do, out, l):
    """Pre-pass kernel of the full-block backward: (delta = rowsum(dO * O),
    1/l), each (B, H, Sq) fp32, from the bf16, fp16 or fp32 ``do`` and
    ``out`` (B, H, Sq, D) and the forward's denominator ``l``."""
    if do.device.type != "cuda":
        raise ValueError(f"full_block_attention_delta: no kernel for device "
                         f"{do.device}")
    if do.dim() != 4 or out.dtype != do.dtype or do.shape != out.shape or \
            tile_plan("full_block", do.dtype, do.shape[3]) is None or \
            not (_aligned(do) and _aligned(out)) or \
            l.shape != do.shape[:3] or not l.is_contiguous():
        raise ValueError(f"full_block_attention_delta: want bf16, fp16 or "
                         f"fp32 (B, H, Sq, D) do and out, D a multiple of 8 "
                         f"up to {FULL_BLOCK_TILES[-1]}, with 16-byte "
                         f"aligned rows and a contiguous (B, H, Sq) l")
    b, h, sq, d = do.shape
    delta, inv_l = _row_stats(do), _row_stats(do)
    _launch("full_block_attention_delta", _entry("full_block_delta",
                                                 do.dtype),
            _ptr(do), _ptr(out), _ptr(l), _ptr(delta), _ptr(inv_l), b, h, sq,
            d, _strides(do, out), _stream_of(do))
    _count(full_block_attention_delta, do)
    return delta, inv_l


full_block_attention_delta.launches = 0


def full_block_attention_bwd(q, k, v, do, out, m, l, *, scale: float,
                             bias: Optional[torch.Tensor] = None):
    """Backward kernels: (dq, dk, dv) from the output cotangent ``do``, the
    forward's ``out`` and its row statistics ``m``, ``l`` (B, H, Sq): the
    delta pre-pass, then one backward launch."""
    _check("full_block_attention_bwd", q, k, v, bias, "full_block",
           grad=True)
    do = kernel_layout(do)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    tile = tile_plan("full_block", q.dtype, d)
    if _f32(q):
        plan = _full_block_f32_plan(tile)
        plan_args = (plan.bwd_rows, plan.bwd_rows, plan.bwd_tile,
                     plan.bwd_smem)
    else:
        plan = _full_block_plan(sq, sk, tile)
        plan_args = (plan.bwd_stages, plan.bwd_smem)
    fn = _entry("full_block_bwd", q.dtype)
    delta, inv_l = full_block_attention_delta(do, out, l)
    dq, dk, dv = _empty_out(q), _empty_out(k), _empty_out(v)
    _launch("full_block_attention_bwd", fn, _ptr(q), _ptr(k), _ptr(v),
            _ptr(bias), _ptr(do), _ptr(m), _ptr(inv_l), _ptr(delta), _ptr(dq),
            _ptr(dk), _ptr(dv), b, h, sq, sk, d, *plan_args, float(scale),
            _strides(q, k, v, do, dq, dk, dv), _stream_of(q))
    _count(full_block_attention_bwd, q)
    return dq, dk, dv


full_block_attention_bwd.launches = 0


def _stream_fwd(q, k, v, bias, scale, grad=False):
    """Forward launch -> (out, lse (B, H, Sq, 1)): the 16-bit kernel (bf16
    or fp16), or for fp32 operands the fp32 one (whose LSE the fp32
    backward takes), at the head dim's tile."""
    _check("stream_attention", q, k, v, bias, "stream", grad=grad)
    b, h, sq, d = q.shape
    out = _empty_out(q)
    lse = _row_stats(q)
    tile = tile_plan("stream", q.dtype, d)
    if q.dtype == torch.float32:
        plan = _stream_f32_plan(tile)
        plan_args = (plan.tile, plan.smem)
    else:
        plan = _stream_plan(tile)
        plan_args = (plan.stages, plan.smem)
    _launch("stream_attention", _entry("stream", q.dtype), _ptr(q), _ptr(k),
            _ptr(v), _ptr(bias), _ptr(out), _ptr(lse), b, h, sq, k.shape[2],
            d, *plan_args, float(scale), _strides(q, k, v, out),
            _stream_of(q))
    _count(stream_attention, q, _wide(d, q.dtype))
    return out, lse[..., None]


def stream_attention_delta(do: torch.Tensor, out: torch.Tensor
                           ) -> torch.Tensor:
    """Pre-pass kernel of the streaming backward: delta = rowsum(dO * O),
    contiguous (B, H, Sq) fp32, from the bf16, fp16 or fp32 (B, H, Sq, D)
    ``do`` and the forward's ``out``. Its plain version is ``_delta``, which
    a CPU tensor gets."""
    if do.device.type == "cpu":
        return _delta(do, out)
    if do.device.type != "cuda":
        raise ValueError(f"stream_attention_delta: no kernel for device "
                         f"{do.device}")
    if do.dim() != 4 or out.dtype != do.dtype or do.shape != out.shape or \
            tile_plan("stream", do.dtype, do.shape[3]) is None or \
            not (_aligned(do) and _aligned(out)):
        raise ValueError(f"stream_attention_delta: want bf16, fp16 or fp32 "
                         f"(B, H, Sq, D) do and out, D a multiple of 8 up "
                         f"to {STREAM_TILES[-1]}, with 16-byte aligned rows")
    b, h, sq, d = do.shape
    delta = _row_stats(do)
    _launch("stream_attention_delta", _entry("stream_delta", do.dtype),
            _ptr(do), _ptr(out), _ptr(delta), b, h, sq, d, _strides(do, out),
            _stream_of(do))
    _count(stream_attention_delta, do, _wide(d, do.dtype))
    return delta


stream_attention_delta.launches = 0


def _stream_bwd_launch(d, dtype, dkv):
    """(entry point, plan arguments) of the dQ (``dkv`` False) or dK/dV
    kernel at head dim ``d``'s tile: bf16 and fp16 (cluster, slots, shared
    bytes) or fp32 (cluster, rows, tile, shared bytes)."""
    tile = tile_plan("stream", dtype, d)
    fn = _entry("stream_dkv" if dkv else "stream_dq", dtype)
    if dtype == torch.float32:
        plan = getattr(_stream_bwd_f32_plan(tile), "dkv" if dkv else "dq")
        return fn, (plan.cluster, plan.rows, plan.tile, plan.smem)
    plan = _stream_bwd_plan(tile)
    return fn, (plan.cluster, plan.stages, plan.smem)


def _stream_bwd_args(name, q, k, v, do, lse, delta, bias):
    _check(name, q, k, v, bias, "stream", grad=True)
    b, h, sq, d = q.shape
    lse = lse.reshape(b, h, sq).contiguous()
    return kernel_layout(do), lse, delta.reshape(b, h, sq).contiguous()


def stream_attention_bwd_dq(q, k, v, do, lse, delta, *, scale: float,
                            bias: Optional[torch.Tensor] = None,
                            full_block: bool = False):
    """dQ kernel: dq from the cotangent ``do``, the forward's ``lse`` and
    ``delta`` = rowsum(dO * O), each (B, H, Sq) or (B, H, Sq, 1) fp32 (a
    ring hop passes global ones), under ``_stream_bwd_plan`` (bf16, fp16)
    or ``_stream_bwd_f32_plan`` (fp32) at the head dim's tile; with
    ``full_block``, P = 1 / Sk for a row with no real key (the full-block
    rule). Its plain version is ``stream_attention_bwd_dq_plain``."""
    do, lse, delta = _stream_bwd_args("stream_attention_bwd_dq", q, k, v, do,
                                      lse, delta, bias)
    b, h, sq, d = q.shape
    fn, plan_args = _stream_bwd_launch(d, q.dtype, dkv=False)
    dq = _empty_out(q)
    _launch("stream_attention_bwd_dq", fn, _ptr(q), _ptr(k), _ptr(v),
            _ptr(bias), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq), b, h, sq,
            k.shape[2], d, *plan_args, int(full_block), float(scale),
            _strides(q, k, v, do, dq, None, None), _stream_of(q))
    _count(stream_attention_bwd_dq, q, _wide(d, q.dtype))
    return dq


stream_attention_bwd_dq.launches = 0


def stream_attention_bwd_dkv(q, k, v, do, lse, delta, *, scale: float,
                             bias: Optional[torch.Tensor] = None,
                             full_block: bool = False):
    """dK/dV kernel: (dk, dv), inputs as ``stream_attention_bwd_dq``. Its
    plain version is ``stream_attention_bwd_dkv_plain``."""
    do, lse, delta = _stream_bwd_args("stream_attention_bwd_dkv", q, k, v,
                                      do, lse, delta, bias)
    b, h, sq, d = q.shape
    fn, plan_args = _stream_bwd_launch(d, q.dtype, dkv=True)
    dk, dv = _empty_out(k), _empty_out(v)
    _launch("stream_attention_bwd_dkv", fn, _ptr(q), _ptr(k), _ptr(v),
            _ptr(bias), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv),
            b, h, sq, k.shape[2], d, *plan_args, int(full_block),
            float(scale), _strides(q, k, v, do, None, dk, dv), _stream_of(q))
    _count(stream_attention_bwd_dkv, q, _wide(d, q.dtype))
    return dk, dv


stream_attention_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------
# custom ops: the forward kernels in PyTorch's dispatcher
# ---------------------------------------------------------------------------


def _fake_out(q):
    """An output of q's shape and dtype with the strides the implementation
    on q's device gives it: the kernels' (B, Sq, H, D) storage on the card,
    the plain version's contiguous (B, H, Sq, D) elsewhere."""
    if q.device.type == "cuda":
        return _empty_out(q)
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@torch.library.custom_op("hivae::full_block_attention", mutates_args=(),
                         device_types="cuda")
def _full_block_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor], scale: float
                   ) -> torch.Tensor:
    q, k, v = (kernel_layout(x) for x in (q, k, v))
    return _full_block_fwd(q, k, v, bias, scale, stats=False)[0]


@_full_block_op.register_kernel("cpu")
def _(q, k, v, bias, scale):
    return full_block_attention_plain(q, k, v, scale=scale, bias=bias)


@_full_block_op.register_fake
def _(q, k, v, bias, scale):
    return _fake_out(q)


@torch.library.custom_op("hivae::full_block_attention_qknorm",
                         mutates_args=(), device_types="cuda")
def _full_block_qknorm_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          gq: torch.Tensor, bq: torch.Tensor,
                          gk: torch.Tensor, bk: torch.Tensor,
                          bias: Optional[torch.Tensor], scale: float,
                          eps: float) -> torch.Tensor:
    q, k, v = (kernel_layout(x) for x in (q, k, v))
    return _full_block_qknorm_fwd(q, k, v, (gq, bq, gk, bk), bias, scale,
                                  eps)


@_full_block_qknorm_op.register_kernel("cpu")
def _(q, k, v, gq, bq, gk, bk, bias, scale, eps):
    return full_block_attention_qknorm_plain(q, k, v, gq, bq, gk, bk,
                                             scale=scale, eps=eps, bias=bias)


@_full_block_qknorm_op.register_fake
def _(q, k, v, gq, bq, gk, bk, bias, scale, eps):
    return _fake_out(q)


@torch.library.custom_op("hivae::stream_attention", mutates_args=(),
                         device_types="cuda")
def _stream_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor], scale: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    q, k, v = (kernel_layout(x) for x in (q, k, v))
    return _stream_fwd(q, k, v, bias, scale)


@_stream_op.register_kernel("cpu")
def _(q, k, v, bias, scale):
    return stream_attention_plain(q, k, v, scale=scale, bias=bias)


@_stream_op.register_fake
def _(q, k, v, bias, scale):
    return _fake_out(q), q.new_empty(q.shape[:3] + (1,), dtype=torch.float32)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _FullBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        q, k, v = (kernel_layout(x) for x in (q, k, v))
        out, m, l = _full_block_fwd(q, k, v, bias, scale, stats=True)
        ctx.save_for_backward(q, k, v, bias, out, m, l)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, m, l = ctx.saved_tensors
        dq, dk, dv = full_block_attention_bwd(q, k, v, do, out, m, l,
                                              scale=ctx.scale, bias=bias)
        return dq, dk, dv, None, None


class _FullBlockQKNorm(torch.autograd.Function):
    """Forward: the fused qk-norm kernel. Backward: the gradient of the
    unfused composition (``qk_layernorm``, then ``_FullBlock``: forward and
    backward kernels), as ``_flash_qknorm_vjp_bwd`` computes it."""

    @staticmethod
    def forward(ctx, q, k, v, bias, gq, bq, gk, bk, scale, eps):
        q, k, v = (kernel_layout(x) for x in (q, k, v))
        out = _full_block_qknorm_fwd(q, k, v, (gq, bq, gk, bk), bias, scale,
                                     eps)
        ctx.save_for_backward(q, k, v, bias, gq, bq, gk, bk)
        ctx.scale, ctx.eps = scale, eps
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, gq, bq, gk, bk = ctx.saved_tensors
        inputs = [x.detach().requires_grad_() for x in (q, k, v, gq, bq, gk,
                                                         bk)]
        qd, kd, vd, gqd, bqd, gkd, bkd = inputs
        with torch.enable_grad():
            out = _FullBlock.apply(qk_layernorm(qd, gqd, bqd, ctx.eps),
                                   qk_layernorm(kd, gkd, bkd, ctx.eps), vd,
                                   bias, ctx.scale)
            dq, dk, dv, dgq, dbq, dgk, dbk = torch.autograd.grad(out, inputs,
                                                                 do)
        return dq, dk, dv, None, dgq, dbq, dgk, dbk, None, None


class _Stream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale, full_block):
        q, k, v = (kernel_layout(x) for x in (q, k, v))
        out, lse = _stream_fwd(q, k, v, bias, scale, grad=True)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.full_block = scale, full_block
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        do = kernel_layout(do)
        delta = stream_attention_delta(do, out)
        kw = dict(scale=ctx.scale, bias=bias, full_block=ctx.full_block)
        dq = stream_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = stream_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _on_a_device(name, q):
    """Refuse a tensor neither on the CPU nor on a CUDA card (a fake
    tensor of ``torch.export`` reports the device it stands for)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {q.device}")


# Each wrapper: with a gradient to record, the plain version on the CPU
# (autograd differentiates it) and the ``torch.autograd.Function`` on the
# card; without one, the custom op (the plain version on the CPU, the
# kernel on the card, a fake while ``torch.export`` traces).


def full_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-block fused attention. q, k, v: (B, H, S, D); bias: optional
    (B, Sk) fp32 additive key bias (0 attend, -1e30 drop) -> (B, H, Sq, D).
    Differentiable in q, k and v."""
    if _needs_grad(q, k, v):
        if q.device.type == "cpu":
            return full_block_attention_plain(q, k, v, scale=scale,
                                              bias=bias)
        return _FullBlock.apply(q, k, v, bias, scale)
    _on_a_device("full_block_attention", q)
    return _full_block_op(q, k, v, bias, float(scale))


full_block_attention.launches = 0


def full_block_attention_qknorm(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, gq: torch.Tensor,
                                bq: torch.Tensor, gk: torch.Tensor,
                                bk: torch.Tensor, *, scale: float,
                                eps: float = 1e-6,
                                bias: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Full-block attention on raw q and k with the per-head LayerNorm
    (``qk_layernorm`` with gamma/beta (D,) and ``eps``) fused into the
    kernel. Differentiable in q, k, v and the four norm parameters."""
    if _needs_grad(q, k, v, gq, bq, gk, bk):
        if q.device.type == "cpu":
            return full_block_attention_qknorm_plain(
                q, k, v, gq, bq, gk, bk, scale=scale, eps=eps, bias=bias)
        return _FullBlockQKNorm.apply(q, k, v, bias, gq, bq, gk, bk, scale,
                                      eps)
    _on_a_device("full_block_attention_qknorm", q)
    return _full_block_qknorm_op(q, k, v, gq, bq, gk, bk, bias, float(scale),
                                 float(eps))


full_block_attention_qknorm.launches = 0


def stream_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float, bias: Optional[torch.Tensor] = None,
                     full_block: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming online-softmax attention -> (out (B, H, Sq, D),
    lse (B, H, Sq, 1) fp32). ``out`` is differentiable in q, k and v;
    ``lse`` carries no gradient. ``full_block``: the backward kernels give
    a row with no real key the full-block softmax's P = 1 / Sk (the
    derivative of the uniform average the forward returns there) rather
    than the streaming kernels' exp(s - lse) = 1; ``ops.attention.sdpa``
    sets it where the JAX rule runs its full-block kernel."""
    if _needs_grad(q, k, v):
        if q.device.type == "cpu":
            return stream_attention_plain(q, k, v, scale=scale, bias=bias)
        return _Stream.apply(q, k, v, bias, scale, bool(full_block))
    _on_a_device("stream_attention", q)
    return _stream_op(q, k, v, bias, float(scale))


stream_attention.launches = 0


class _Launches:
    """The launch count of an fp32 (or fp16) kernel, apart from its bf16
    sibling's (``<wrapper>.launches``): the wrapper called with fp32 (fp16)
    operands adds one to ``launches`` where it launches that kernel; a wide
    streaming kernel's likewise (``<wrapper>_wide``, bf16 operands, and its
    ``_f16`` and ``_f32`` forms)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0

    def __repr__(self):
        return f"<{self.__name__}: {self.launches} launches>"


stream_attention_f32 = _Launches("stream_attention_f32")
full_block_attention_f32 = _Launches("full_block_attention_f32")
full_block_attention_qknorm_f32 = _Launches(
    "full_block_attention_qknorm_f32")
full_block_attention_bwd_f32 = _Launches("full_block_attention_bwd_f32")
full_block_attention_delta_f32 = _Launches(
    "full_block_attention_delta_f32")
stream_attention_delta_f32 = _Launches("stream_attention_delta_f32")
stream_attention_bwd_dq_f32 = _Launches("stream_attention_bwd_dq_f32")
stream_attention_bwd_dkv_f32 = _Launches("stream_attention_bwd_dkv_f32")
full_block_attention_f16 = _Launches("full_block_attention_f16")
full_block_attention_qknorm_f16 = _Launches(
    "full_block_attention_qknorm_f16")
full_block_attention_bwd_f16 = _Launches("full_block_attention_bwd_f16")
full_block_attention_delta_f16 = _Launches(
    "full_block_attention_delta_f16")
stream_attention_f16 = _Launches("stream_attention_f16")
stream_attention_delta_f16 = _Launches("stream_attention_delta_f16")
stream_attention_bwd_dq_f16 = _Launches("stream_attention_bwd_dq_f16")
stream_attention_bwd_dkv_f16 = _Launches("stream_attention_bwd_dkv_f16")
# the wide streaming kernels' counters (tiles past STREAM_NARROW_MAX)
stream_attention_wide = _Launches("stream_attention_wide")
stream_attention_wide_f16 = _Launches("stream_attention_wide_f16")
stream_attention_wide_f32 = _Launches("stream_attention_wide_f32")
stream_attention_delta_wide = _Launches("stream_attention_delta_wide")
stream_attention_delta_wide_f16 = _Launches("stream_attention_delta_wide_f16")
stream_attention_delta_wide_f32 = _Launches("stream_attention_delta_wide_f32")
stream_attention_bwd_dq_wide = _Launches("stream_attention_bwd_dq_wide")
stream_attention_bwd_dq_wide_f16 = _Launches(
    "stream_attention_bwd_dq_wide_f16")
stream_attention_bwd_dq_wide_f32 = _Launches(
    "stream_attention_bwd_dq_wide_f32")
stream_attention_bwd_dkv_wide = _Launches("stream_attention_bwd_dkv_wide")
stream_attention_bwd_dkv_wide_f16 = _Launches(
    "stream_attention_bwd_dkv_wide_f16")
stream_attention_bwd_dkv_wide_f32 = _Launches(
    "stream_attention_bwd_dkv_wide_f32")
