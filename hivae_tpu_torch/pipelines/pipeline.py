"""Single-window clip reconstruction (port of ``_recon_clip`` and
``AMDReconstructionPipeline.sample`` of ``hivae_tpu/pipelines/pipeline.py``)
on tensors: SD-VAE encode of the RGB (and grey) frames, AMD motion
extraction and Euler decode of the 16 targets from the reference frame,
SD-VAE decode to uint8. Reading and writing mp4 files is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import amd as amd_mod
from ..models import vae as vae_mod


@torch.no_grad()
def reconstruct_clip(vae: vae_mod.AutoencoderKL, amd: amd_mod.AMDModelNew,
                     pixels: torch.Tensor, grey: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     sample_step: int = 20,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(F+1, 3, H, W) pixels in [-1, 1] (frame 0 is the reference) ->
    reconstructed (F+1, 3, H, W) uint8. ``grey`` is the grey clip, needed
    when the model's config has ``use_grey``. The Euler start noise is
    ``noise`` (F, C, h, w) when given, else drawn from ``generator``."""
    z = vae_mod.vae_encode(vae, pixels[None])[0]
    refimg_z, gt = z[:1], z[1:][None]
    ref = refimg_z[:, None].expand(gt.shape)
    grey_kw = {}
    if amd.cfg.use_grey:
        if grey is None:
            raise ValueError("the model uses grey frames: pass grey=")
        gz = vae_mod.vae_encode(vae, grey[None])[0]
        grey_kw = dict(video_grey=gz[1:][None],
                       ref_img_grey=gz[:1][None].expand(gt.shape))
    gt = gt.to(amd.diffusion_transformer.proj_out.weight.dtype)
    _, video_pre, _ = amd_mod.sample(amd, gt, ref.to(gt), sample_step=sample_step,
                                     generator=generator, noise=noise,
                                     **{k: v.to(gt) for k, v in grey_kw.items()})
    result = torch.cat([refimg_z[None].to(video_pre), video_pre], dim=1)
    return vae_mod.vae_decode_rgb(vae, result)[0]


class AMDReconstructionPipeline:
    """Single-window video reconstruction through the motion bottleneck."""

    def __init__(self, vae: vae_mod.AutoencoderKL, amd: amd_mod.AMDModelNew,
                 window: int = 16):
        self.vae, self.amd, self.window = vae, amd, window

    def sample(self, pixels: torch.Tensor, grey: Optional[torch.Tensor] = None,
               video_sample_step: int = 20,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(window+1, 3, H, W) clip in [-1, 1] -> the reconstructed clip as
        uint8 of the same shape."""
        if pixels.shape[0] != self.window + 1:
            raise ValueError(f"expected {self.window + 1} frames (reference "
                             f"+ window), got {pixels.shape[0]}")
        return reconstruct_clip(self.vae, self.amd, pixels, grey, generator,
                                video_sample_step, noise)
