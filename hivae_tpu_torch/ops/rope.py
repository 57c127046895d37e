"""Rotary position embeddings and RoPE attention (port of
``hivae_tpu/ops/rope.py``).

The rotation uses real cos/sin tables on interleaved (even, odd) channel
pairs, the complex multiply of the reference written as a 2-D rotation, in
fp32, cast back to the input's dtype. ``rope_attention`` runs through the
port's ``sdpa``, so above 256^2 logits a bf16 call reaches a kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .attention import sdpa


def precompute_freqs_cis(dim: int, seq_len: int, base: float = 10000.0,
                         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (seq_len, dim // 2) fp32: the real and imaginary
    parts of the reference's e^{i m theta} table, computed in fp64 on the
    host."""
    i = np.arange(1, dim // 2 + 1, dtype=np.float64)
    theta = base ** (-2.0 * (i - 1.0) / dim)
    ang = np.outer(np.arange(seq_len, dtype=np.float64), theta)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved (even, odd) channel pairs of (B, S, H, D)."""
    xr = x.float().reshape(x.shape[:-1] + (-1, 2))
    a, b = xr[..., 0], xr[..., 1]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.stack([a * c - b * s, a * s + b * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_rotary_emb(xq: torch.Tensor, xk: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k (B, S, H, D) by position."""
    return _rotate(xq, cos, sin), _rotate(xk, cos, sin)


def rope_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cos: Optional[torch.Tensor] = None,
                   sin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RoPE, then scaled dot-product attention over (B, S, H, D) inputs ->
    (B, S, H, D). The tables default to fresh ones for the input length."""
    if cos is None or sin is None:
        cos, sin = precompute_freqs_cis(q.shape[-1], q.shape[1],
                                        device=q.device)
    q, k = apply_rotary_emb(q, k, cos, sin)
    out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2)
