"""Attention kernels for Hopper with their plain PyTorch versions.

Two TPU kernels of ``hivae_tpu/ops/pallas/flash_attention.py`` are on the
clip-reconstruction path and are ported here as hand-written CUDA
(``hivae_tpu_torch/csrc``):

* ``full_block_attention`` replaces ``_fwd_kernel`` (``_flash_fwd_impl``):
  the joint and motion-encoder attentions, S of 260-512, D = 64.
  Source note and bound: ``csrc/flash_full_block.cu``.
* ``stream_attention`` replaces ``_stream_fwd_kernel``
  (``_stream_fwd_impl`` / ``stream_fwd_lse``): the SD-VAE mid-block
  attention, (17, 1, 1024, 512), returning O and the per-row LSE.
  Source note and bound: ``csrc/flash_stream.cu``.

Each wrapper runs its plain version for a tensor on the CPU (the tests) and
launches its kernel for a CUDA tensor, or raises; there is no fallback from
one to the other. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

_KERNEL_DTYPES = (torch.bfloat16,)
_FULL_BLOCK_DIMS = (32, 64, 96, 128)
_STREAM_DIMS = (64, 128, 256, 512)


# ---------------------------------------------------------------------------
# plain versions (the semantics; the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------


def _logits(q, k, scale, bias):
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()[:, None, None, :]
    return logits


def full_block_attention_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, scale: float,
                               bias: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """softmax(q.k^T * scale + bias) . v with fp32 logits and softmax, the
    normalised probabilities cast to v's dtype, fp32 accumulation."""
    p = torch.softmax(_logits(q, k, scale, bias), dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def stream_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, scale: float,
                           bias: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse (B, H, Sq, 1) fp32): the unnormalised exp(s - max) cast to
    v's dtype for P.V, divided by the fp32 row sum afterwards."""
    logits = _logits(q, k, scale, bias)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / denom
    return out.to(q.dtype), m + torch.log(denom)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _check(name, q, k, v, bias, dims):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    for x in (q, k, v):
        if x.device != q.device:
            raise ValueError(f"{name}: q, k, v must share one device")
        if x.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, "
                            f"got {x.dtype}")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"{name}: want (B, H, S, D) with a contiguous "
                             f"last dim, got {tuple(x.shape)} strides "
                             f"{x.stride()}")
        if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be 16-byte aligned "
                             f"(strides {x.stride()})")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"{name}: shape mismatch q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in dims:
        raise ValueError(f"{name}: head dim {d} not in {dims}")
    if bias is not None and (bias.dtype != torch.float32 or
                             bias.shape != (b, k.shape[2]) or
                             not bias.is_contiguous() or
                             bias.device != q.device):
        raise ValueError(f"{name}: bias must be a contiguous (B, Sk) fp32 "
                         f"tensor on the device of q")


def _strides(*xs):
    vals = [s for x in xs for s in x.stride()[:3]]
    return (ctypes.c_long * len(vals))(*vals)


def _ptr(x):
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def _empty_out(q):
    # (B, Sq, H, D) storage seen as (B, H, Sq, D): merging heads afterwards
    # is a view, not a copy
    b, h, sq, d = q.shape
    return torch.empty((b, sq, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _full_block_fn():
    lib = _build.load("flash_full_block")
    fn = lib.hv_full_block_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.hv_full_block_error_string.restype = ctypes.c_char_p
    return fn, lib.hv_full_block_error_string


@functools.lru_cache(maxsize=None)
def _stream_fn():
    lib = _build.load("flash_stream")
    fn = lib.hv_stream_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.hv_stream_error_string.restype = ctypes.c_char_p
    return fn, lib.hv_stream_error_string


def full_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-block fused attention. q, k, v: (B, H, S, D); bias: optional
    (B, Sk) fp32 additive key bias (0 attend, -1e30 drop) -> (B, H, Sq, D)."""
    if q.device.type == "cpu":
        return full_block_attention_plain(q, k, v, scale=scale, bias=bias)
    _check("full_block_attention", q, k, v, bias, _FULL_BLOCK_DIMS)
    b, h, sq, d = q.shape
    out = _empty_out(q)
    fn, err_str = _full_block_fn()
    strides = _strides(q, k, v, out)
    rc = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), b, h, sq,
            k.shape[2], d, float(scale), ctypes.cast(strides, ctypes.c_void_p),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"full_block_attention launch failed: "
                           f"{err_str(rc).decode()}")
    full_block_attention.launches += 1
    return out


full_block_attention.launches = 0


def stream_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float, bias: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming online-softmax attention -> (out (B, H, Sq, D),
    lse (B, H, Sq, 1) fp32)."""
    if q.device.type == "cpu":
        return stream_attention_plain(q, k, v, scale=scale, bias=bias)
    _check("stream_attention", q, k, v, bias, _STREAM_DIMS)
    b, h, sq, d = q.shape
    out = _empty_out(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn, err_str = _stream_fn()
    strides = _strides(q, k, v, out)
    rc = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), _ptr(lse), b, h,
            sq, k.shape[2], d, float(scale),
            ctypes.cast(strides, ctypes.c_void_p),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"stream_attention launch failed: "
                           f"{err_str(rc).decode()}")
    stream_attention.launches += 1
    return out, lse[..., None]


stream_attention.launches = 0
