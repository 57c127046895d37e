"""3-D frequency band split (port of ``hivae_tpu/ops/frequency.py``).

The Gaussian low-pass over centred normalised (T, H, W) frequencies is
applied with ``torch.fft`` in fp32, the mask ``ifftshift``-ed once so it
multiplies the unshifted spectrum directly; the high band is ``x - low``.
``freq_3d_filter`` splits with a given centred mask; ``get_views`` and
``generate_weight_sequence`` are the sliding temporal windows of a long
video and their triangular blending weights.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=64)
def _gaussian_lpf_np(shape: Tuple[int, int, int], d_s: float, d_t: float,
                     shifted: bool) -> np.ndarray:
    """Mask ``exp(-0.5 d^2)`` with per-axis coordinates
    ``(arange(n)*2/n - 1) / d`` (``1/d_t`` temporal, ``1/d_s`` spatial)."""
    T, H, W = shape
    if d_s == 0 or d_t == 0:
        return np.zeros(shape, dtype=np.float32)
    t = (np.arange(T, dtype=np.float32) * 2.0 / T - 1.0) / d_t
    h = (np.arange(H, dtype=np.float32) * 2.0 / H - 1.0) / d_s
    w = (np.arange(W, dtype=np.float32) * 2.0 / W - 1.0) / d_s
    d2 = t[:, None, None] ** 2 + h[None, :, None] ** 2 + w[None, None, :] ** 2
    mask = np.exp(-0.5 * d2).astype(np.float32)
    if shifted:
        mask = np.fft.ifftshift(mask)
    return mask


def gaussian_low_pass_filter(shape, d_s: float = 0.25,
                             d_t: float = 0.25) -> torch.Tensor:
    """Centred Gaussian low-pass mask over the last three dims of
    ``shape``, broadcast to ``shape``."""
    T, H, W = shape[-3], shape[-2], shape[-1]
    mask = torch.from_numpy(
        _gaussian_lpf_np((T, H, W), float(d_s), float(d_t), False))
    return mask.expand(tuple(shape)) if len(shape) > 3 else mask


def freq_3d_split(x: torch.Tensor, d_s: float, d_t: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) bands of ``x`` (..., T, H, W) for static cutoffs."""
    if d_s == 0 or d_t == 0:
        return torch.zeros_like(x), x
    t, h, w = x.shape[-3:]
    mask = torch.from_numpy(
        _gaussian_lpf_np((t, h, w), float(d_s), float(d_t), True)).to(x.device)
    spec = torch.fft.fftn(x.float(), dim=(-3, -2, -1))
    low = torch.fft.ifftn(spec * mask, dim=(-3, -2, -1)).real.to(x.dtype)
    return low, x - low


def freq_3d_filter(x: torch.Tensor, lpf: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) bands of ``x`` (..., T, H, W) under a centred
    (fftshift-convention) low-pass mask ``lpf`` (broadcast against x): the
    reference's fftshift, mask, ifftshift chain with the shifts folded
    into the mask. The sums run in fp32; both bands come back in x's
    dtype."""
    lpf3 = torch.fft.ifftshift(lpf.to(x.device), dim=(-3, -2, -1))
    xf = x.float()
    spec = torch.fft.fftn(xf, dim=(-3, -2, -1))
    low = torch.fft.ifftn(spec * lpf3, dim=(-3, -2, -1)).real
    return low.to(x.dtype), (xf - low).to(x.dtype)


def get_views(video_length: int, window_size: int = 16, stride: int = 4):
    """Sliding temporal windows [(start, end), ...] over a long video."""
    num_blocks_time = (video_length - window_size) // stride + 1
    return [(int(i * stride), int(i * stride) + window_size)
            for i in range(num_blocks_time)]


def generate_weight_sequence(n: int):
    """Triangular blending weights of ``n`` overlapped windows."""
    if n % 2 == 0:
        m = n // 2
        return list(range(1, m + 1)) + list(range(m, 0, -1))
    m = (n + 1) // 2
    return list(range(1, m)) + [m] + list(range(m - 1, 0, -1))
