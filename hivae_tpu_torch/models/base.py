"""A generic conditioned rectified-flow harness and the timestep samplers
(port of ``hivae_tpu/models/base.py``).

``RectifiedFlowHarness`` wraps any ``velocity_fn(zt, conds, timestep)``
with the training tuple (``forward``) and an Euler walk (``sample``, with
uniform steps or the logarithmic ``get_sample_t_schedule``). Every draw
is an input: the timesteps and noise of ``forward``, the start noise of
``sample``, the normal draw of ``sample_t`` and ``sample_timestep``; a
missing one comes from the caller's generator.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch


def sample_t(num_samples: int, m: float = 0.0, s: float = 1.0,
             normal: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Logit-normal t in (0, 1): sigmoid(m + s * normal)."""
    if normal is None:
        normal = torch.randn((num_samples,), generator=generator)
    return torch.sigmoid(m + s * normal.float())


def sample_timestep(num_samples: int, m: float = 0.0, s: float = 1.0,
                    num_steps: int = 1000,
                    normal: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Logit-normal integer timesteps (int32), truncated toward zero."""
    t = sample_t(num_samples, m, s, normal, generator)
    return (t * num_steps).to(torch.int32)


def get_sample_t_schedule(t_schedule: Optional[Dict] = None,
                          sample_steps: int = 10) -> np.ndarray:
    """Logarithmic dt schedule summing to 1 (fp32), from ``t_schedule``'s
    ``m`` (default 1) and ``n`` (default 100)."""
    t_schedule = t_schedule or {}
    m = t_schedule.get("m", 1)
    n = t_schedule.get("n", 100)
    logm, logn = math.log(m), math.log(n)
    progress = np.linspace(0, 1, sample_steps + 1)
    logmn = np.log(progress * (m - n) + n)
    t = 1 - (logm - logmn) / (logm - logn)
    return np.diff(t).astype(np.float32)


class RectifiedFlowHarness:
    """Conditioned rectified-flow training and sampling around
    ``velocity_fn(zt, conds, timestep)`` -> velocity of zt's shape; the
    timestep reaches it as fp32."""

    def __init__(self, velocity_fn: Callable, num_steps: int = 1000):
        self.velocity_fn = velocity_fn
        self.num_steps = num_steps

    def forward(self, motion_gt: torch.Tensor, conds,
                timestep: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """-> (zt, motion_pred, vel_pred, vel_gt); ``timestep`` (N,) ints
        in [0, num_steps] and ``noise`` of motion_gt's shape are drawn
        (in that order) when None."""
        n = motion_gt.shape[0]
        dev = motion_gt.device
        if timestep is None:
            timestep = torch.randint(0, self.num_steps + 1, (n,),
                                     generator=generator, device=dev)
        timestep = timestep.to(dev)
        t = (1.0 - timestep.float() / self.num_steps).reshape(
            (n,) + (1,) * (motion_gt.dim() - 1))
        if noise is None:
            noise = torch.randn(motion_gt.shape, generator=generator,
                                device=dev, dtype=motion_gt.dtype)
        noise = noise.to(motion_gt)
        vel_gt = motion_gt - noise
        zt = t * motion_gt + (1 - t) * noise
        vel_pred = self.velocity_fn(zt, conds, timestep.float())
        motion_pred = zt + (1 - t) * vel_pred
        return zt, motion_pred, vel_pred, vel_gt

    def sample(self, shape, conds, sample_steps: int = 10,
               t_schedule: Optional[Dict] = None,
               z0: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
        """Euler walk from ``z0`` (fp32 normal of ``shape`` when None) with
        uniform steps, or ``get_sample_t_schedule(t_schedule)``'s."""
        z = (torch.randn(shape, generator=generator, device=device)
             if z0 is None else z0.float())
        if t_schedule is not None:
            dts = get_sample_t_schedule(t_schedule, sample_steps)
        else:
            dts = np.full((sample_steps,), 1.0 / sample_steps, np.float32)
        timestep = torch.full((shape[0],), float(self.num_steps),
                              device=z.device)
        for dt in dts:
            vel = self.velocity_fn(z, conds, timestep)
            z = z + float(dt) * vel
            timestep = timestep - float(dt) * self.num_steps
        return z
