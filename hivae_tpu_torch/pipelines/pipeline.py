"""Single-window clip reconstruction (port of ``_recon_clip`` and
``AMDReconstructionPipeline.sample`` of ``hivae_tpu/pipelines/pipeline.py``)
on tensors: SD-VAE encode of the RGB (and grey) frames, AMD motion
extraction and Euler decode of the 16 targets from the reference frame,
SD-VAE decode to uint8. ``quant="int8"`` serves the Euler loop's DiT and the
VAE decode in w8a8 (``ops/quant.py``). Reading and writing mp4 files is not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import amd as amd_mod
from ..models import vae as vae_mod
from ..ops import quant as quant_ops

# Each table covers exactly the modules its quantised leg runs: the DiT for
# the Euler loop, the decoder for the decode leg (the encode stays in the
# compute dtype, so stripping the decoder's weights leaves it whole).
QUANT_SCOPES = {"dit": ("diffusion_transformer",), "vae": ("decoder",)}


@torch.no_grad()
def reconstruct_clip(vae: vae_mod.AutoencoderKL, amd: amd_mod.AMDModelNew,
                     pixels: torch.Tensor, grey: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     sample_step: int = 20,
                     noise: Optional[torch.Tensor] = None,
                     quant_table=None, vae_quant_table=None) -> torch.Tensor:
    """(F+1, 3, H, W) pixels in [-1, 1] (frame 0 is the reference) ->
    reconstructed (F+1, 3, H, W) uint8. ``grey`` is the grey clip, needed
    when the model's config has ``use_grey``. The Euler start noise is
    ``noise`` (F, C, h, w) when given, else drawn from ``generator``.
    ``quant_table`` / ``vae_quant_table`` (``ops.quant.quantize_params`` of
    ``amd`` and ``vae``) run the Euler loop and the decode in int8."""
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
                                     quant_table=quant_table,
                                     **{k: v.to(gt) for k, v in grey_kw.items()})
    result = torch.cat([refimg_z[None].to(video_pre), video_pre], dim=1)
    return vae_mod.vae_decode_rgb(vae, result, quant_table=vae_quant_table)[0]


class AMDReconstructionPipeline:
    """Single-window video reconstruction through the motion bottleneck.

    ``quant="int8"`` quantises the DiT's and the VAE decoder's large layers
    (``ops.quant.quantize_params`` with ``QUANT_SCOPES``) and strips their
    float weights from ``amd`` and ``vae`` in place, so the serving models
    hold int8 and scales where the tables cover them; every clip then runs
    the Euler loop and the decode in int8."""

    def __init__(self, vae: vae_mod.AutoencoderKL, amd: amd_mod.AMDModelNew,
                 window: int = 16, quant: Optional[str] = None):
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant mode {quant!r}; use 'int8' or "
                             "None")
        self.vae, self.amd, self.window = vae, amd, window
        self.quant_table = self.vae_quant_table = None
        if quant == "int8":
            self.quant_table = quant_ops.quantize_params(
                amd, scope=QUANT_SCOPES["dit"])
            self.vae_quant_table = quant_ops.quantize_params(
                vae, scope=QUANT_SCOPES["vae"])
            quant_ops.strip_quantized(amd, self.quant_table)
            quant_ops.strip_quantized(vae, self.vae_quant_table)

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
                                video_sample_step, noise,
                                quant_table=self.quant_table,
                                vae_quant_table=self.vae_quant_table)
