"""Fused int8 FFN-up + tanh-GELU + per-token requantise for Hopper, with
its plain PyTorch version.

Replaces ``hivae_tpu/ops/pallas/quant_ffn.py::_kernel`` (driven by
``fused_ffn_up_quant``): for per-token int8 activations ``xq`` (M, K) with
scales ``sx`` (M, 1) and per-output-channel int8 weights, it computes

    y  = float(xq @ w) * (sx * ws) + b          (int32 accumulate, fp32)
    y  = gelu_tanh(y)                           (fp32)
    sy = max(max_n |y|, 1e-8) / 127             (per row, over all N)
    yq = clip(round_half_even(y / sy), -127, 127) as int8

and returns ``(yq, sy)``, the FFN-down's int8 input, so the (M, N) GELU
output never reaches device memory. The hand-written kernel is
``hivae_tpu_torch/csrc/quant_ffn.cu`` (source note and bound there): one
pass over K on ``wgmma``, the row maximum shared across a thread-block
cluster along N, with the launch plan from ``_ffn_plan``.

The weight is stored as the port's quantisation table stores every dense
weight: ``w8`` (N, K) int8, row-major, the layout of a ``torch.nn.Linear``
weight (its transpose is the column-major (K, N) operand the int8 tensor
cores and ``torch._int_mm`` take).

``fused_ffn_up_quant`` runs the plain version for tensors on the CPU and
launches the kernel for CUDA tensors, or raises; there is no fallback from
one to the other. Both go through the ``torch.library`` custom op
``torch.ops.hivae.ffn_up_quant``, so an exported int8 sampler keeps the
kernel as a graph node. It is forward-only, as in the JAX package (the int8 path
serves samplers, which never differentiate). ``fused_ffn_up_quant.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from . import _build

LANE = 128  # K and N multiples of this (the JAX gate; also the kernel's tiles)

# launch plan of csrc/quant_ffn.cu: 64 rows x 512 columns a CTA, a cluster
# of at most 8 CTAs (the portable size) along N, a 3-slot ring of 64 + 512
# rows of 128 bytes of K, 1024-byte aligned
FFN_ROWS = 64
FFN_COLS = 512
FFN_MAX_CLUSTER = 8
FFN_STAGES = 3
FFN_SMEM = 1024 + FFN_STAGES * (FFN_ROWS + FFN_COLS) * LANE
# its static shared bytes: the mbarriers, two warpgroups' row maxima, every
# cluster CTA's row maxima by row-block parity, the row scales, and the
# CTA's (ws, bias) columns
FFN_STATIC = (8 * FFN_STAGES + 4 * 2 * FFN_ROWS
              + 4 * 2 * FFN_MAX_CLUSTER * FFN_ROWS + 4 * FFN_ROWS
              + 8 * FFN_COLS)


def supports(m: int, k: int, n: int) -> bool:
    """True when the fused schedule handles the geometry: K and N multiples
    of 128 (the JAX package's lane gate, and the CUDA kernel's K chunk and
    N tile). M is unrestricted (the kernel masks the ragged last rows); the
    TPU's VMEM row-tile budget (``_pick_mt``) does not apply on the card."""
    return m > 0 and k > 0 and n > 0 and k % LANE == 0 and n % LANE == 0


# fewest rows torch._int_mm takes on the card (cuBLASLt int8 needs M > 16)
INT8_MM_MIN_ROWS = 17


def int8_mm(a: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact int32 (M, N) = a (M, K) int8 @ w8 (N, K) int8 transposed, via
    ``torch._int_mm`` (cuBLASLt int8 on the card, which takes the weight's
    transpose column-major, as it is here, and needs M > 16 and K, N
    multiples of 8). Fewer than ``INT8_MM_MIN_ROWS`` rows are padded with
    zero rows, which change no other row, and the result is sliced back."""
    m = a.shape[0]
    if m >= INT8_MM_MIN_ROWS:
        return torch._int_mm(a.contiguous(), w8.t())
    pad = a.new_zeros((INT8_MM_MIN_ROWS - m, a.shape[1]))
    return torch._int_mm(torch.cat([a, pad]), w8.t())[:m]


def int8_scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-8) / 127, the symmetric int8 scale, as the IEEE
    quotient the JAX package and the kernel take: PyTorch divides a CUDA
    tensor by a Python number as a product with its reciprocal, which can
    be an ulp off, so the divisor here is a tensor."""
    m = torch.clamp_min(absmax, 1e-8)
    return m / torch.full_like(m, 127.0)


def requant_rows(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of fp32 ``y`` (..., N): scale
    max(max |y|, 1e-8) / 127, values rounded half to even and clipped to
    +-127 -> (int8 values, fp32 scales (..., 1))."""
    s = int8_scale(y.abs().amax(dim=-1, keepdim=True))
    return torch.clamp(torch.round(y / s), -127, 127).to(torch.int8), s


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    """tanh-GELU, 0.5 y (1 + tanh(sqrt(2/pi) (y + 0.044715 y^3))), written
    one fp32 operation at a time: each rounds on its own, so the kernel,
    which spells out the same operations with round-to-nearest intrinsics
    and the same ``tanhf``, gives the same bits on the card."""
    inner = 0.7978845608028654 * (y + 0.044715 * (y * y * y))
    return 0.5 * y * (1.0 + torch.tanh(inner))


def fused_ffn_up_quant_plain(xq: torch.Tensor, sx: torch.Tensor,
                             w8: torch.Tensor, wscale: torch.Tensor,
                             bias: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in the TPU kernel's order: int32 accumulate,
    fp32 dequant ``acc * (sx * ws) + b``, fp32 tanh-GELU (``gelu_tanh``),
    per-row abs-max, divide, round half to even, clip. ``xq`` (M, K) int8,
    ``sx`` (M, 1) fp32, ``w8`` (N, K) int8, ``wscale`` and ``bias`` (N,)
    fp32 -> (yq (M, N) int8, sy (M, 1) fp32)."""
    acc = int8_mm(xq, w8)
    y = acc.float() * (sx.float() * wscale.float()) + bias.float()
    return requant_rows(gelu_tanh(y))


@dataclasses.dataclass(frozen=True)
class FfnPlan:
    """Launch plan of the FFN-up kernel: a cluster of ``cluster`` CTAs along
    N, each ``rows`` x ``cols`` a chunk, shares the row maximum of its rows;
    a CTA takes ``chunks`` column chunks (``chunks`` > 1 only where N is
    wider than one portable cluster, and then the earlier chunks are
    computed twice), with ``smem`` bytes of dynamic shared memory. The
    clusters are persistent: the C entry point launches as many as the card
    holds at once, at most one for each block of ``rows`` rows, and they
    walk the row blocks."""
    cluster: int
    rows: int
    cols: int
    chunks: int
    smem: int


def _ffn_plan(m: int, k: int, n: int) -> FfnPlan:
    """The plan ``hv_quant_ffn_up`` takes at (M, K, N) (``ffn_cluster`` and
    ``ffn_chunks`` in csrc/quant_ffn.cu). M and K do not change it."""
    cluster = min(FFN_MAX_CLUSTER, -(-n // FFN_COLS))
    return FfnPlan(cluster=cluster, rows=FFN_ROWS, cols=FFN_COLS,
                   chunks=-(-n // (FFN_COLS * cluster)), smem=FFN_SMEM)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    lib = _build.load("quant_ffn")
    fn = lib.hv_quant_ffn_up
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.hv_quant_ffn_error_string
    err.restype = ctypes.c_char_p
    return fn, err


def _check(xq, sx, w8, wscale, bias):
    if xq.device.type != "cuda":
        raise ValueError(f"fused_ffn_up_quant: no kernel for device "
                         f"{xq.device}")
    m, k = xq.shape
    n = w8.shape[0]
    want = {"xq": (xq, torch.int8, (m, k)), "sx": (sx, torch.float32, (m, 1)),
            "w8": (w8, torch.int8, (n, k)),
            "wscale": (wscale, torch.float32, (n,)),
            "bias": (bias, torch.float32, (n,))}
    for name, (x, dtype, shape) in want.items():
        if (x.device != xq.device or x.dtype != dtype
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"fused_ffn_up_quant: {name} must be a "
                             f"contiguous {dtype} {shape} tensor on "
                             f"{xq.device}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    if not supports(m, k, n):
        raise ValueError(f"fused_ffn_up_quant: K {k} and N {n} must be "
                         f"multiples of {LANE}")


@torch.library.custom_op("hivae::ffn_up_quant", mutates_args=(),
                         device_types="cuda")
def _ffn_up_op(xq: torch.Tensor, sx: torch.Tensor, w8: torch.Tensor,
               wscale: torch.Tensor, bias: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(xq, sx, w8, wscale, bias)
    m, k = xq.shape
    n = w8.shape[0]
    yq = torch.empty((m, n), dtype=torch.int8, device=xq.device)
    sy = torch.empty((m, 1), dtype=torch.float32, device=xq.device)
    plan = _ffn_plan(m, k, n)
    fn, err = _kernel_fn()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    rc = fn(*(ctypes.c_void_p(t.data_ptr())
              for t in (xq, sx, w8, wscale, bias, yq, sy)), m, k, n,
            plan.cluster, plan.chunks, plan.smem, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_ffn_up_quant launch failed: "
                           f"{err(rc).decode()}")
    fused_ffn_up_quant.launches += 1
    return yq, sy


@_ffn_up_op.register_kernel("cpu")
def _(xq, sx, w8, wscale, bias):
    return fused_ffn_up_quant_plain(xq, sx, w8, wscale, bias)


@_ffn_up_op.register_fake
def _(xq, sx, w8, wscale, bias):
    m, n = xq.shape[0], w8.shape[0]
    return (xq.new_empty((m, n), dtype=torch.int8),
            xq.new_empty((m, 1), dtype=torch.float32))


def fused_ffn_up_quant(xq: torch.Tensor, sx: torch.Tensor, w8: torch.Tensor,
                       wscale: torch.Tensor, bias: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(quantised x) -> int8 activations + per-row scales for the FFN-down;
    arguments and result as ``fused_ffn_up_quant_plain``. The bias is
    required (pass zeros for a layer without one). It runs the custom op
    ``torch.ops.hivae.ffn_up_quant``: the plain version on the CPU, the
    kernel on the card (its launch counted there), a fake (shapes and
    dtypes) while ``torch.export`` traces."""
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ffn_up_quant: no kernel for device "
                         f"{xq.device}")
    return _ffn_up_op(xq, sx, w8, wscale, bias)


fused_ffn_up_quant.launches = 0
