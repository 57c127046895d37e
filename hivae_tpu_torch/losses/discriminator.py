"""GAN discriminators and the adversarial loss helpers (port of
``hivae_tpu/losses/discriminator.py``).

The convolutional discriminators normalise with ``BatchNorm``, the port's
copy of flax's ``nn.BatchNorm`` (``torch.nn.BatchNorm*d`` differs from it):
batch statistics in fp32 with flax's fast variance, mean(x^2) - mean^2
clipped at 0; running statistics updated as ``0.99 * running + 0.01 *
batch``, the running variance with the *biased* batch variance; eps 1e-5.
``train=True`` normalises with the batch statistics and updates the
running ones (flax's ``use_running_average=False`` with a mutable
``batch_stats``), ``train=False`` normalises with the running ones. The
parameter bridge maps flax's ``batch_stats`` (``mean``, ``var``) onto the
``running_mean`` and ``running_var`` buffers.

Inputs are NCHW (NCTHW for the 3-D ones). ``Discriminator2DAttn``'s
blocks attend over 16 x 16 patches at 32 x 32 latents: 256^2 logits, the
plain path.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..models.blocks import (AdaLayerNorm, AdaLNZeroSingle, DiTBlock,
                             FeedForward, Mlp, PatchEmbed, TimestepEmbedding)
from ..models.dit import _pos2d
from ..utils.device import resolve_device

Device = Any


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over channel dim 1 (see the module note)."""

    def __init__(self, channels: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            axes = [0] + list(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x.float() - mean.reshape(shape)) * mul.reshape(shape)
        return (y + self.bias.float().reshape(shape)).to(x.dtype)


def _lrelu(x):
    return F.leaky_relu(x, negative_slope=0.2)


class _ConvStack(nn.Module):
    """conv_0 (stride 2, bias) -> LReLU, then ``n_layers - 1`` stride-2
    convs and one stride-1 conv without bias, each -> BatchNorm ->
    LReLU; ``top`` caps the last conv's width multiplier (8 for the
    PatchGANs, 4 for the pooled discriminators)."""

    def __init__(self, dims: int, in_channels: int, ndf: int, n_layers: int,
                 kernel: int, top: int):
        super().__init__()
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        self.conv_0 = conv(in_channels, ndf, kernel, stride=2, padding=1)
        prev = ndf
        for n in range(1, n_layers + 1):
            nf = min(2 ** n, 8 if n < n_layers else top)
            stride = 2 if n < n_layers else 1
            setattr(self, f"conv_{n}", conv(prev, ndf * nf, kernel,
                                            stride=stride, padding=1,
                                            bias=False))
            setattr(self, f"norm_{n}", BatchNorm(ndf * nf))
            prev = ndf * nf
        self.n_layers, self.out_channels = n_layers, prev

    def features(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = _lrelu(self.conv_0(x))
        for n in range(1, self.n_layers + 1):
            x = getattr(self, f"conv_{n}")(x)
            x = _lrelu(getattr(self, f"norm_{n}")(x, train))
        return x


def _built(module: nn.Module, device, dtype) -> None:
    module.to(device=device, dtype=dtype)
    for m in module.modules():   # running statistics stay fp32
        if isinstance(m, BatchNorm):
            m.running_mean.data = m.running_mean.float()
            m.running_var.data = m.running_var.float()


class NLayerDiscriminator(_ConvStack):
    """2-D PatchGAN: (N, C, H, W) -> (N, 1, h', w') logits."""

    def __init__(self, in_channels: int = 3, ndf: int = 64,
                 n_layers: int = 3, device: Device = None,
                 dtype: torch.dtype = torch.float32):
        dev = resolve_device(device)
        with torch.device(dev):
            super().__init__(2, in_channels, ndf, n_layers, 4, 8)
            self.conv_out = nn.Conv2d(self.out_channels, 1, 4, padding=1)
        _built(self, dev, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.conv_out(self.features(x, train))


class NLayerDiscriminator3D(_ConvStack):
    """3-D PatchGAN over (N, C, T, H, W) volumes -> (N, 1, t', h', w')."""

    def __init__(self, in_channels: int = 3, ndf: int = 64,
                 n_layers: int = 3, device: Device = None,
                 dtype: torch.dtype = torch.float32):
        dev = resolve_device(device)
        with torch.device(dev):
            super().__init__(3, in_channels, ndf, n_layers, 4, 8)
            self.conv_out = nn.Conv3d(self.out_channels, 1, 4, padding=1)
        _built(self, dev, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.conv_out(self.features(x, train))


class _PooledDiscriminator(_ConvStack):
    """A 3x3(x3) conv stack, global average pool, MLP (exact GELU) to a
    score (N,), sigmoid with ``use_sigmoid``."""

    def __init__(self, dims: int, in_channels: int, ndf: int, n_layers: int,
                 mlp_hidden_dim: int, use_sigmoid: bool, device,
                 out_dim: int = 1):
        dev = resolve_device(device)
        with torch.device(dev):
            super().__init__(dims, in_channels, ndf, n_layers, 3, 4)
            self.mlp_fc1 = nn.Linear(self.out_channels, mlp_hidden_dim)
            self.mlp_fc2 = nn.Linear(mlp_hidden_dim, out_dim)
        self.use_sigmoid = use_sigmoid
        self._dev = dev

    def pooled_mlp(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.features(x, train)
        x = x.mean(dim=tuple(range(2, x.dim())))
        return self.mlp_fc2(F.gelu(self.mlp_fc1(x)))

    def _score(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x) if self.use_sigmoid else x


class Discriminator3DConv(_PooledDiscriminator):
    """(N, C, T, H, W) -> score (N,)."""

    def __init__(self, in_channels: int = 4, ndf: int = 64,
                 n_layers: int = 3, mlp_hidden_dim: int = 256,
                 use_sigmoid: bool = False, device: Device = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(3, in_channels, ndf, n_layers, mlp_hidden_dim,
                         use_sigmoid, device)
        _built(self, self._dev, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self._score(self.pooled_mlp(x, train)[:, 0])


class Discriminator2DConv(_PooledDiscriminator):
    """(N, C, H, W) per-frame latents -> score (N,)."""

    def __init__(self, in_channels: int = 4, ndf: int = 64,
                 n_layers: int = 3, mlp_hidden_dim: int = 256,
                 use_sigmoid: bool = False, device: Device = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(2, in_channels, ndf, n_layers, mlp_hidden_dim,
                         use_sigmoid, device)
        _built(self, self._dev, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self._score(self.pooled_mlp(x, train)[:, 0])


class Discriminator2DConvVel(_PooledDiscriminator):
    """Timestep-conditioned: (N, C, H, W) (zi ‖ zt) and timestep (N,) ->
    score (N,); the pooled features' MLP, AdaLN-Zero's modulation by the
    timestep embedding, a FeedForward to one value."""

    def __init__(self, in_channels: int = 8, ndf: int = 64,
                 n_layers: int = 3, mlp_hidden_dim: int = 256,
                 time_embed_dim: int = 256, use_sigmoid: bool = False,
                 device: Device = None, dtype: torch.dtype = torch.float32):
        hidden = ndf * min(2 ** n_layers, 4)
        super().__init__(2, in_channels, ndf, n_layers, mlp_hidden_dim,
                         use_sigmoid, device, out_dim=hidden)
        with torch.device(self._dev):
            self.time_embedding = TimestepEmbedding(time_embed_dim, hidden)
            self.norm = AdaLNZeroSingle(hidden, hidden)
            self.ff = FeedForward(hidden, inner_dim=2 * hidden, out_dim=1)
        _built(self, self._dev, dtype)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        x = self.pooled_mlp(x, train)
        emb = self.time_embedding(timestep)
        h, _ = self.norm(x[:, None], emb)
        return self._score(self.ff(h)[:, 0, 0])


class Discriminator2DAttn(nn.Module):
    """Transformer discriminator over patchified (zi ‖ zt) latents
    (N, C, H, W) with timestep AdaLN -> score (N,)."""

    def __init__(self, in_channels: int = 8, latent_width: int = 32,
                 latent_height: int = 32, patch_size: int = 2,
                 head_dim: int = 64, heads: int = 12, num_layers: int = 8,
                 mlp_hidden_dim: int = 512, use_sigmoid: bool = False,
                 device: Device = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = heads * head_dim
        patches = (latent_height // patch_size) * (latent_width // patch_size)
        self.use_sigmoid = use_sigmoid
        dev = resolve_device(device)
        with torch.device(dev):
            self.time_embedding = TimestepEmbedding(hidden, 512)
            self.image_patch_embed = PatchEmbed(patch_size, in_channels,
                                                hidden)
            self.transformer_blocks = nn.ModuleList(
                [DiTBlock(hidden, heads, head_dim, 512)
                 for _ in range(num_layers)])
            self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
            self.norm_out = AdaLayerNorm(hidden, 512)
            self.mlp = Mlp(patches * hidden, mlp_hidden_dim, 1)
        self.register_buffer("pos", _pos2d(hidden, latent_height,
                                           latent_width, patch_size),
                             persistent=False)
        self.to(device=dev, dtype=dtype)

    def forward(self, image_hidden_states: torch.Tensor,
                timestep: torch.Tensor) -> torch.Tensor:
        n = image_hidden_states.shape[0]
        emb = self.time_embedding(timestep)
        x = self.image_patch_embed(image_hidden_states)
        x = x + self.pos.to(x.dtype)
        for block in self.transformer_blocks:
            x = block(x, emb)
        x = self.norm_out(self.norm_final(x), emb)
        x = self.mlp(x.reshape(n, -1))[:, 0]
        return torch.sigmoid(x) if self.use_sigmoid else x


# -- GAN objectives --------------------------------------------------------------


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))


def generator_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return -torch.mean(logits_fake)


def adaptive_gan_weight(nll_grad_norm: torch.Tensor,
                        g_grad_norm: torch.Tensor,
                        max_weight: float = 1e4) -> torch.Tensor:
    """The taming-style adaptive weight from the last layer's gradient
    norms, clipped to [0, max_weight]."""
    return torch.clamp(nll_grad_norm / (g_grad_norm + 1e-4), 0.0, max_weight)
