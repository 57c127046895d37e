"""Diagonal-Gaussian posterior and KL regulariser (port of
``hivae_tpu/ops/regularizers.py``): parameters chunked into (mean, logvar)
on one axis, logvar clamped to [-30, 20], a reparameterised sample, and
the KL to N(0, 1) summed over the non-batch axes and averaged over the
batch."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_params(cls, parameters: torch.Tensor,
                    dim: int = 1) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(parameters, 2, dim=dim)
        return cls(mean, torch.clamp(logvar, -30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise; ``noise`` drawn from ``generator`` unless
        given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + self.std * noise.to(self.mean)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, reduce_dims: Sequence[int] = (1, 2)) -> torch.Tensor:
        """KL(q || N(0, 1)) summed over ``reduce_dims``."""
        return 0.5 * torch.sum(self.mean.square() + self.var - 1.0 -
                               self.logvar, dim=tuple(reduce_dims))

    def nll(self, sample: torch.Tensor,
            reduce_dims: Sequence[int] = (1, 2)) -> torch.Tensor:
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar +
            (sample - self.mean).square() / self.var, dim=tuple(reduce_dims))


def diagonal_gaussian_regularize(
        parameters: torch.Tensor, *, sample: bool = True, dim: int = 1,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, kl_loss): the posterior's sample (``noise``, the shape of its
    mean, or drawn from ``generator``) or its mode, and the KL summed over
    the non-batch dims and divided by the batch."""
    post = DiagonalGaussian.from_params(parameters, dim=dim)
    z = post.sample(generator, noise) if sample else post.mode()
    kl = post.kl(tuple(range(1, parameters.dim())))
    return z, kl.sum() / kl.shape[0]
