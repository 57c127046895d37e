"""The legacy CNN motion autoencoder (port of
``hivae_tpu/models/model_ae.py``).

Per frame, the duo-frame mix [previous frame (the first frame for frame
0) ‖ frame] -> ``DownEncoder`` (conv_in 3x3) -> ``Upsampler`` ->
``MapConv`` over [previous frame ‖ motion] predicts the frame; the loss is
the MSE over frames 1..T.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ..utils.device import resolve_device
from .conv_blocks import DownEncoder, MapConv, Upsampler

Device = Any


class CNNMotionAE(nn.Module):
    def __init__(self, inchannel: int = 4, upsampler_outchannel: int = 4,
                 block_out_channels_down: Sequence[int] = (64, 128, 256, 256),
                 norm_groups: int = 4, device: Device = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        down = tuple(block_out_channels_down)
        dev = resolve_device(device)
        with torch.device(dev):
            self.dfd_encoder = DownEncoder(2 * inchannel, down, norm_groups,
                                           conv_in_kernel=3)
            self.upsampler = Upsampler(down[-1], tuple(reversed(down)),
                                       upsampler_outchannel, norm_groups)
            self.mapconv = MapConv(inchannel + upsampler_outchannel,
                                   out_channel=inchannel, groups=2)
        self.to(device=dev, dtype=dtype)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """video (B, T, C, H, W) latents -> predicted frames (B, T, C, H,
        W)."""
        b, t, c, h, w = video.shape
        video = video.to(self.mapconv.conv_out.weight.dtype)
        shift_video = torch.cat([video[:, :1], video[:, :-1]], dim=1)
        duo = torch.cat([shift_video, video], dim=2).reshape(b * t, 2 * c,
                                                             h, w)
        motion = self.upsampler(self.dfd_encoder(duo)).reshape(b, t, -1, h, w)
        mix = torch.cat([shift_video, motion], dim=2)
        return self.mapconv(mix.reshape(b * t, -1, h, w)).reshape(b, t, c,
                                                                  h, w)

    @staticmethod
    def loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        d = pred[:, 1:].float() - gt[:, 1:].float()
        return torch.mean(torch.square(d))
