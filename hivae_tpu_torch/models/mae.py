"""Masked autoencoder ViT on VAE latents (port of
``hivae_tpu/models/mae.py``).

Patchify 4 x 32 x 32 latents into 256 patches of 2 x 2, keep a random
(1 - mask_ratio) share of them, encode [cls; kept] with ViT blocks and
fixed sincos positions, then a lighter decoder over [cls; kept and mask
tokens in patch order] predicts every patch; the loss is the per-patch
MSE (optionally against pix-normalised targets) over the masked patches.

Attention: at mask ratio 0.75 the encoder runs 1 + 64 tokens (the plain
path); the decoder always runs 1 + 256 = 257 tokens at head dim 512 / 16
= 32, above 256^2 logits, so ``ops.attention.sdpa`` sends it to the
full-block kernel; ``reconstruct`` (mask ratio 0) also runs the encoder at
257 tokens (head dim 64). The masking draw (``noise``, uniform (N, 256))
is an input; the stable ``argsort`` of the same draw gives the JAX
package's permutation.

Parameters (counted by ``tests/test_torch_mae.py`` on both sides):
``MAE_S`` 110.7 M and ``MAE_L`` 328.1 M (about 12 d^2 a ViT block), not
the JAX docstring's "~150M / ~500M".
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import embeddings as emb_ops
from ..utils.device import resolve_device
from .blocks import Attention, PatchEmbed

Device = Any


class ViTBlock(nn.Module):
    """timm-style ViT block: LN (eps 1e-6) -> MHA (qkv bias, no qk-norm)
    -> LN -> MLP (exact GELU)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, dim // heads, qk_norm=False)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


def _pos_embed_with_cls(dim: int, h: int, w: int) -> torch.Tensor:
    pos = emb_ops.get_2d_sincos_pos_embed(dim, (h, w))
    return torch.from_numpy(np.concatenate(
        [np.zeros((1, dim), np.float32), pos], axis=0))[None]


class MaskedAutoencoderViT(nn.Module):
    def __init__(self, img_size: Tuple[int, int] = (32, 32),
                 patch_size: int = 2, in_chans: int = 4,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 decoder_embed_dim: int = 512, decoder_depth: int = 8,
                 decoder_num_heads: int = 16, mlp_ratio: float = 4.0,
                 norm_pix_loss: bool = False, device: Device = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.patch_size = tuple(img_size), patch_size
        self.in_chans, self.norm_pix_loss = in_chans, norm_pix_loss
        gh, gw = self.grid
        dev = resolve_device(device)
        with torch.device(dev):
            self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
            self.cls_token = nn.Parameter(torch.randn(1, 1, embed_dim) * 0.02)
            self.transformer_blocks = nn.ModuleList(
                [ViTBlock(embed_dim, num_heads, mlp_ratio)
                 for _ in range(depth)])
            self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
            self.decoder_embed = nn.Linear(embed_dim, decoder_embed_dim)
            self.mask_token = nn.Parameter(
                torch.randn(1, 1, decoder_embed_dim) * 0.02)
            self.decoder_blocks = nn.ModuleList(
                [ViTBlock(decoder_embed_dim, decoder_num_heads, mlp_ratio)
                 for _ in range(decoder_depth)])
            self.decoder_norm = nn.LayerNorm(decoder_embed_dim, eps=1e-6)
            self.decoder_pred = nn.Linear(decoder_embed_dim,
                                          patch_size ** 2 * in_chans)
        self.register_buffer("pos", _pos_embed_with_cls(embed_dim, gh, gw),
                             persistent=False)
        self.register_buffer("decoder_pos", _pos_embed_with_cls(
            decoder_embed_dim, gh, gw), persistent=False)
        self.to(device=dev, dtype=dtype)

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size,
                self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        return self.grid[0] * self.grid[1]

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) -> (N, patches, p * p * C), MAE's (p, p, C) order."""
        n, c, h, w = imgs.shape
        p = self.patch_size
        x = imgs.reshape(n, c, h // p, p, w // p, p)
        x = x.permute(0, 2, 4, 3, 5, 1)
        return x.reshape(n, (h // p) * (w // p), p * p * c)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """``patchify``'s (N, patches, p * p * C) -> (N, C, H, W), with the
        JAX package's axis order."""
        n, s, d = x.shape
        p = self.patch_size
        gh, gw = self.grid
        c = d // (p * p)
        x = x.reshape(n, gh, gw, p, p, c).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(n, c, gh * p, gw * p)

    def forward(self, imgs: torch.Tensor, mask_ratio: float = 0.75,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Training forward -> (loss (fp32 scalar), pred (N, patches, p*p*C),
        mask (N, patches), 1 = masked). ``noise`` (N, patches) uniform
        orders the patches (drawn from ``generator`` when None)."""
        n = imgs.shape[0]
        num_patches = self.num_patches
        len_keep = int(num_patches * (1 - mask_ratio))
        dtype = self.decoder_pred.weight.dtype

        x = self.patch_embed(imgs.to(dtype)) + self.pos[:, 1:].to(dtype)
        if noise is None:
            noise = torch.rand((n, num_patches), generator=generator,
                               device=imgs.device)
        ids_shuffle = torch.argsort(noise.to(imgs.device), dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :len_keep]
        x = torch.gather(x, 1, ids_keep[:, :, None].expand(
            -1, -1, x.shape[-1]))
        mask = torch.ones((n, num_patches), device=imgs.device)
        mask[:, :len_keep] = 0
        mask = torch.gather(mask, 1, ids_restore)

        cls = (self.cls_token + self.pos[:, :1]).to(x.dtype)
        x = torch.cat([cls.expand(n, 1, -1), x], dim=1)
        for block in self.transformer_blocks:
            x = block(x)
        x = self.decoder_embed(self.norm(x))

        mask_tokens = self.mask_token.to(x.dtype).expand(
            n, num_patches - len_keep, -1)
        x_ = torch.cat([x[:, 1:], mask_tokens], dim=1)
        x_ = torch.gather(x_, 1, ids_restore[:, :, None].expand(
            -1, -1, x_.shape[-1]))
        x = torch.cat([x[:, :1], x_], dim=1) + self.decoder_pos.to(x.dtype)
        for block in self.decoder_blocks:
            x = block(x)
        pred = self.decoder_pred(self.decoder_norm(x))[:, 1:]

        target = self.patchify(imgs)
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, unbiased=False)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        loss = torch.mean(torch.square(pred.float() - target.float()), dim=-1)
        loss = torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1)
        return loss, pred, mask

    def reconstruct(self, imgs: torch.Tensor) -> torch.Tensor:
        """The mask ratio 0 round trip -> (N, C, H, W)."""
        _, pred, _ = self(imgs, mask_ratio=0.0,
                          noise=torch.zeros(imgs.shape[0], self.num_patches,
                                            device=imgs.device))
        return self.unpatchify(pred)


def MAE_S(device: Device = None, dtype: torch.dtype = torch.float32,
          **kw) -> MaskedAutoencoderViT:
    return MaskedAutoencoderViT(embed_dim=768, depth=12, num_heads=12,
                                decoder_embed_dim=512, decoder_depth=8,
                                decoder_num_heads=16, device=device,
                                dtype=dtype, **kw)


def MAE_L(device: Device = None, dtype: torch.dtype = torch.float32,
          **kw) -> MaskedAutoencoderViT:
    return MaskedAutoencoderViT(embed_dim=1024, depth=24, num_heads=16,
                                decoder_embed_dim=512, decoder_depth=8,
                                decoder_num_heads=16, device=device,
                                dtype=dtype, **kw)


MAE_MODELS = {"MAE_S": MAE_S, "MAE_L": MAE_L}
