"""Diagonal-Gaussian posterior (port of ``hivae_tpu/ops/regularizers.py``):
parameters chunked into (mean, logvar) on one axis, logvar clamped to
[-30, 20]."""

from __future__ import annotations

from typing import NamedTuple, Optional

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
