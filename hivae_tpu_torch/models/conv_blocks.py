"""SD-VAE convolutional blocks (port of ``hivae_tpu/models/conv_blocks.py``)
in NCHW, with diffusers parameter names. The mid-block attention goes
through ``ops.attention.sdpa``: at the flagship's 32x32 latent and 512
channels it is a (B, 1, 1024, 512) attention, the streaming kernel's case.
"""

from __future__ import annotations

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
    """resnet -> attention -> resnet."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels, groups),
                                      ResnetBlock2D(channels, channels, groups)])
        self.attentions = nn.ModuleList([AttentionBlock2D(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        return self.resnets[1](self.attentions[0](x))


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
