"""AutoencoderKL, the frozen SD-VAE latent path (port of
``hivae_tpu/models/vae.py``): 256x256 RGB <-> 4x32x32 latents with scaling
factor 0.18215, NCHW at every public function, diffusers parameter names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant as quant_ops
from ..ops.regularizers import DiagonalGaussian
from ..utils.device import resolve_device
from ..utils.misc import no_grad
from .conv_blocks import DownEncoderBlock2D, UNetMidBlock2D, UpDecoderBlock2D

SD_VAE_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = SD_VAE_SCALE


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            DownEncoderBlock2D(ch[max(i - 1, 0)], c, cfg.layers_per_block, g,
                               add_downsample=i != len(ch) - 1)
            for i, c in enumerate(ch)])
        self.mid_block = UNetMidBlock2D(ch[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = tuple(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = UNetMidBlock2D(rev[0], g)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock2D(rev[max(i - 1, 0)], c, cfg.layers_per_block + 1,
                             g, add_upsample=i != len(rev) - 1)
            for i, c in enumerate(rev)])
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """KL-regularised conv autoencoder; ``encode_moments`` returns the
    posterior moments, ``decode`` maps latents to images (NCHW)."""

    def __init__(self, cfg: VAEConfig = VAEConfig(),
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        with torch.device(dev):
            self.encoder = VAEEncoder(cfg)
            self.decoder = VAEDecoder(cfg)
            self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                        2 * cfg.latent_channels, 1)
            self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                             cfg.latent_channels, 1)
        self.to(device=dev, dtype=dtype)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """(N,C,H,W) image -> (N, 2*latent, h, w) moments."""
        return self.quant_conv(self.encoder(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(N, latent, h, w) -> (N, C, H, W) image."""
        return self.decoder(self.post_quant_conv(z))


def _dtype(vae: AutoencoderKL) -> torch.dtype:
    return vae.quant_conv.weight.dtype


@no_grad
def vae_encode(vae: AutoencoderKL, video: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               scale: float = SD_VAE_SCALE,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,T,C,H,W) pixels -> (N,T,latent,h,w) scaled latents: the posterior
    mode, or a posterior sample when ``noise`` (N*T, latent, h, w) or a
    ``generator`` is given."""
    n, t = video.shape[:2]
    flat = video.reshape((n * t,) + video.shape[2:]).to(_dtype(vae))
    dist = DiagonalGaussian.from_params(vae.encode_moments(flat), dim=1)
    if noise is None and generator is None:
        z = dist.mode()
    else:
        z = dist.sample(generator, noise)
    z = z * scale
    return z.reshape((n, t) + z.shape[1:])


def decode_latents(vae: AutoencoderKL, latents: torch.Tensor,
                   scale: float = SD_VAE_SCALE) -> torch.Tensor:
    """(M, latent, h, w) scaled latents -> (M, C, H, W) pixels, with
    gradients: the perceptual loss decodes the predicted latents here."""
    return vae.decode(latents.to(_dtype(vae)) / scale)


@no_grad
def vae_decode(vae: AutoencoderKL, latents: torch.Tensor,
               scale: float = SD_VAE_SCALE, quant_table=None) -> torch.Tensor:
    """(N,T,latent,h,w) scaled latents -> (N,T,C,H,W) pixels in [-1, 1].
    ``quant_table`` (``ops.quant.quantize_params(vae, scope=("decoder",))``)
    runs the decoder's large convolutions and mid-block projections in
    int8; the encode leg is never quantised."""
    n, t = latents.shape[:2]
    with quant_ops.maybe_quantized(vae, quant_table):
        img = decode_latents(
            vae, latents.reshape((n * t,) + latents.shape[2:]), scale)
    return img.reshape((n, t) + img.shape[1:])


def latents_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> [0, 255] uint8 (truncating, as the JAX package)."""
    img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
    return (img * 255).to(torch.uint8)


def vae_decode_rgb(vae: AutoencoderKL, latents: torch.Tensor,
                   scale: float = SD_VAE_SCALE,
                   quant_table=None) -> torch.Tensor:
    """Decode + quantise to uint8."""
    return latents_to_rgb(vae_decode(vae, latents, scale,
                                     quant_table=quant_table))
