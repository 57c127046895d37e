"""2-D Haar DWT and its inverse as strided slice arithmetic (port of
``hivae_tpu/ops/wavelet.py``): stride-2 subsampling with +/- combinations
over (N, C, H, W) tensors, no convolution. ``iwt2`` takes the bands
stacked on the batch axis, the reference's convention."""

from __future__ import annotations

from typing import Tuple

import torch


def dwt2(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Forward Haar DWT: (N, C, H, W) -> (LL, HL, LH, HH), each
    (N, C, H/2, W/2)."""
    x01 = x[:, :, 0::2, :] / 2
    x02 = x[:, :, 1::2, :] / 2
    x1 = x01[:, :, :, 0::2]
    x2 = x02[:, :, :, 0::2]
    x3 = x01[:, :, :, 1::2]
    x4 = x02[:, :, :, 1::2]
    ll = x1 + x2 + x3 + x4
    hl = -x1 - x2 + x3 + x4
    lh = -x1 + x2 - x3 + x4
    hh = x1 - x2 - x3 + x4
    return ll, hl, lh, hh


def iwt2(x: torch.Tensor) -> torch.Tensor:
    """Inverse Haar DWT: (4B, C, h, w), the bands [LL; HL; LH; HH] stacked
    on the batch axis -> (B, C, 2h, 2w)."""
    b = x.shape[0] // 4
    x1, x2, x3, x4 = (x[i * b:(i + 1) * b] / 2 for i in range(4))
    ee = x1 - x2 - x3 + x4  # rows 0::2, columns 0::2
    oe = x1 - x2 + x3 - x4  # rows 1::2, columns 0::2
    eo = x1 + x2 - x3 - x4  # rows 0::2, columns 1::2
    oo = x1 + x2 + x3 + x4  # rows 1::2, columns 1::2
    n, c, h, w = ee.shape
    row_e = torch.stack([ee, eo], dim=-1).reshape(n, c, h, 2 * w)
    row_o = torch.stack([oe, oo], dim=-1).reshape(n, c, h, 2 * w)
    return torch.stack([row_e, row_o], dim=-2).reshape(n, c, 2 * h, 2 * w)


def iwt2_from_bands(ll, hl, lh, hh) -> torch.Tensor:
    """The inverse from four (N, C, h, w) bands."""
    return iwt2(torch.cat([ll, hl, lh, hh], dim=0))
