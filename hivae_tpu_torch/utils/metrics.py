"""Quality metrics: PSNR, SSIM and LPIPS (port of
``hivae_tpu/utils/metrics.py``), in fp32 on the tensors' device."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB; the default range 2.0 is that of
    video in [-1, 1]."""
    mse = torch.mean(torch.square(pred.float() - gt.float()))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_window(window: int, sigma: float, device) -> torch.Tensor:
    r = window // 2
    g = torch.exp(-0.5 * (torch.arange(window, dtype=torch.float32) - r) ** 2
                  / sigma ** 2)
    g = g / g.sum()
    return (g[:, None] * g[None, :])[None, None].to(device)


def ssim(pred: torch.Tensor, gt: torch.Tensor, data_range: float = 2.0,
         window: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Structural similarity (Wang et al. 2004): Gaussian-windowed local
    statistics, K1 = 0.01, K2 = 0.03, a depthwise blur with VALID padding
    (``F.conv2d`` on each channel of each frame). Takes (..., C, H, W);
    frames and channels are averaged."""
    x = pred.float().reshape((-1, 1) + tuple(pred.shape[-2:]))
    y = gt.float().reshape((-1, 1) + tuple(gt.shape[-2:]))
    kern = _gaussian_window(window, sigma, x.device)

    def blur(v):
        return F.conv2d(v, kern)

    mu_x, mu_y = blur(x), blur(y)
    sxx = blur(x * x) - mu_x * mu_x
    syy = blur(y * y) - mu_y * mu_y
    sxy = blur(x * y) - mu_x * mu_y
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sxx + syy + c2)
    return torch.mean(num / den)


def lpips_distance(lpips_model, pred: torch.Tensor,
                   gt: torch.Tensor) -> torch.Tensor:
    """Mean LPIPS (``losses.lpips.LPIPS``) over a batch of frames, NCHW or
    (N, F, C, H, W), in [-1, 1]."""
    if pred.dim() == 5:
        pred = pred.reshape((-1,) + tuple(pred.shape[2:]))
        gt = gt.reshape((-1,) + tuple(gt.shape[2:]))
    return torch.mean(lpips_model(pred, gt))
