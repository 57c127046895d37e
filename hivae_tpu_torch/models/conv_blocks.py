"""SD-VAE convolutional blocks (port of ``hivae_tpu/models/conv_blocks.py``)
in NCHW, with diffusers parameter names, and the generic stacks of the CNN
motion autoencoder (``DownEncoder``, ``Upsampler``, ``MapConv``). The
mid-block attention goes through ``ops.attention.sdpa``: at the flagship's
32x32 latent and 512 channels it is a (B, 1, 1024, 512) attention, the
streaming kernel's case. ``DownEncoder`` and ``Upsampler`` attend over the
h/8 x w/8 grid (16 tokens at 32x32 latents, the plain path); ``MapConv``
attends over the full h x w grid at 640 channels, a (B, 1, 1024, 640)
attention at 32x32 latents: the streaming kernel's too (its forward, and
in training its backward kernels).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attn_ops


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv3x3 -> GN -> SiLU -> conv3x3 (+1x1 shortcut)."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 conv3x3 after an asymmetric (0, 1, 0, 1) pad."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    """2x nearest-neighbour upsample + conv3x3. The upsample is a broadcast
    and reshape: the same values as ``F.interpolate(mode='nearest')``, and
    its backward is a sum over each 2x2 block rather than the atomic
    scatter of the interpolate backward, so a training step through the
    decoder repeats bit for bit."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        x = x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2)
        return self.conv(x.reshape(n, c, 2 * h, 2 * w))


class AttentionBlock2D(nn.Module):
    """Single-head spatial self-attention over the H*W tokens with a
    GroupNorm front (diffusers VAE mid-block attention, head_dim = C)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.group_norm(x).reshape(n, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        out = attn_ops.sdpa(q[:, None], k[:, None], v[:, None])[:, 0]
        out = self.to_out[0](out)
        return x + out.transpose(1, 2).reshape(n, c, h, w)


class UNetMidBlock2D(nn.Module):
    """resnet -> attention -> resnet (no attention without
    ``add_attention``)."""

    def __init__(self, channels: int, groups: int = 32,
                 add_attention: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels, groups),
                                      ResnetBlock2D(channels, channels, groups)])
        self.attentions = nn.ModuleList(
            [AttentionBlock2D(channels, groups)] if add_attention else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        for attn in self.attentions:
            x = attn(x)
        return self.resnets[1](x)


class DownEncoderBlock2D(nn.Module):
    """N resnets + optional stride-2 downsample."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 2, groups: int = 32,
                 add_downsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_channels if i == 0 else out_channels,
                           out_channels, groups) for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels)])
                             if add_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock2D(nn.Module):
    """N resnets + optional 2x upsample."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 2, groups: int = 32,
                 add_upsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_channels if i == 0 else out_channels,
                           out_channels, groups) for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels)])
                           if add_upsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class DownEncoder(nn.Module):
    """Generic conv encoder: conv_in (``conv_in_kernel`` square, same
    padding) -> down blocks (a stride-2 downsample after each but the last)
    -> mid block -> GroupNorm/SiLU/conv_out."""

    def __init__(self, in_channels: int,
                 block_out_channels: Sequence[int] = (64, 128, 256, 256),
                 norm_groups: int = 32, resnet_layers_per_block: int = 2,
                 add_attention: bool = True, conv_in_kernel: int = 3):
        super().__init__()
        ch = list(block_out_channels)
        k = conv_in_kernel
        self.conv_in = nn.Conv2d(in_channels, ch[0], k, padding=(k - 1) // 2)
        self.downblock = nn.ModuleList(
            [DownEncoderBlock2D(ch[max(i - 1, 0)], c,
                                resnet_layers_per_block, norm_groups,
                                add_downsample=i != len(ch) - 1)
             for i, c in enumerate(ch)])
        self.mid_block = UNetMidBlock2D(ch[-1], norm_groups, add_attention)
        self.conv_norm_out = nn.GroupNorm(norm_groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], ch[-1], 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.downblock:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Upsampler(nn.Module):
    """Generic conv decoder: conv_in -> mid block -> up blocks (a 2x
    upsample after each but the last) -> GroupNorm/SiLU/conv_out, then
    ``conv_final`` to ``out_channel`` when it is given."""

    def __init__(self, in_channels: int,
                 block_out_channels: Sequence[int] = (256, 256, 128, 64),
                 out_channel: Optional[int] = None, norm_groups: int = 8,
                 resnet_layers_per_block: int = 2,
                 add_attention: bool = True):
        super().__init__()
        ch = list(block_out_channels)
        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.mid_block = UNetMidBlock2D(ch[0], norm_groups, add_attention)
        self.upblock = nn.ModuleList(
            [UpDecoderBlock2D(ch[max(i - 1, 0)], c, resnet_layers_per_block,
                              norm_groups, add_upsample=i != len(ch) - 1)
             for i, c in enumerate(ch)])
        self.conv_norm_out = nn.GroupNorm(norm_groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], ch[-1], 3, padding=1)
        self.conv_final = (nn.Conv2d(ch[-1], out_channel, 3, padding=1)
                           if out_channel is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(x))
        for block in self.upblock:
            x = block(x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        if self.conv_final is not None:
            x = self.conv_final(x)
        return x


class MapConv(nn.Module):
    """Shape-preserving channel mapper: conv_in -> mid block (attention)
    -> ``block_layer`` resnets -> conv_out."""

    def __init__(self, in_channels: int, hidden: int = 640,
                 out_channel: int = 4, block_layer: int = 8, groups: int = 2):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, hidden, 3, padding=1)
        self.mid_block = UNetMidBlock2D(hidden, groups)
        self.map = nn.ModuleList([ResnetBlock2D(hidden, hidden, groups)
                                  for _ in range(block_layer)])
        self.conv_out = nn.Conv2d(hidden, out_channel, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(x))
        for block in self.map:
            x = block(x)
        return self.conv_out(x)
