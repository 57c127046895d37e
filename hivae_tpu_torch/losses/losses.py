"""Reconstruction and perceptual losses (port of
``hivae_tpu/losses/losses.py``): ``l1``, ``l2`` and ``LpipsMseLoss``, the
velocity loss plus a weighted LPIPS between the VAE-decoded predicted frames
and the ground-truth frames. The trainer composes the same perceptual leg
inline over the model's own loss dict, as the JAX trainer does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.vae import SD_VAE_SCALE, decode_latents


def l1(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - gt.float()))


def l2(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - gt.float()))


class LpipsMseLoss:
    """Velocity loss + ``perceptual_weight`` * LPIPS(decode(zj_pred), gt).

    Call with (video_gt (N,T,C,H,W) or (M,C,H,W) pixels, zj_pred (M, latent,
    h, w) scaled latents, v_pred, v_gt); the decode keeps gradients."""

    def __init__(self, vae, lpips, loss_type: str = "l2",
                 perceptual_weight: float = 0.5):
        self.vae, self.lpips = vae, lpips
        self.loss_func = l1 if loss_type == "l1" else l2
        self.perceptual_weight = perceptual_weight

    def __call__(self, video_gt: torch.Tensor, zj_pred: torch.Tensor,
                 v_pred: torch.Tensor, v_gt: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rec_loss = self.loss_func(v_pred, v_gt)
        if video_gt.dim() == 5:
            video_gt = video_gt.reshape((-1,) + video_gt.shape[2:])
        if self.perceptual_weight > 0:
            video_pre = decode_latents(self.vae, zj_pred, SD_VAE_SCALE)
            p_loss = torch.mean(self.lpips(video_pre, video_gt.to(video_pre))
                                .float())
        else:
            p_loss = torch.zeros_like(rec_loss)
        loss = rec_loss + self.perceptual_weight * p_loss
        return loss, {"loss": loss, "rec_loss": rec_loss,
                      "lpips_loss": p_loss}
