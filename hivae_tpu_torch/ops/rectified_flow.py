"""Rectified flow (port of ``hivae_tpu/ops/rectified_flow.py``).

Integer steps in [0, num_steps] map to time ``t = (num_steps - step) /
num_steps``. Training interpolates ``z_t = t * z1 + (1 - t) * z0`` with the
velocity target ``z1 - z0``; Euler walks a precomputed high-to-low step
sequence with ``dt = 1 / len(step_seq)``. The walk is a Python loop.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

DEFAULT_NUM_STEPS = 1000


def timestep_to_time(timestep: torch.Tensor,
                     num_steps: int = DEFAULT_NUM_STEPS,
                     ndim: int = 4) -> torch.Tensor:
    """Integer step(s) -> continuous time; a 1-D batch broadcasts against
    an ``ndim``-dimensional batch of samples."""
    t = (num_steps - timestep.float()) / num_steps
    if t.dim() == 1:
        t = t.reshape((-1,) + (1,) * (ndim - 1))
    return t


def get_train_tuple(z1: torch.Tensor, timestep: torch.Tensor,
                    z0: torch.Tensor, num_steps: int = DEFAULT_NUM_STEPS):
    """(z_t, target = z1 - z0) at integer steps ``timestep`` (batch,) from
    the source sample ``z0``."""
    t = timestep_to_time(timestep, num_steps, ndim=z1.dim())
    return t * z1 + (1.0 - t) * z0, z1 - z0


def get_target_with_zt_vel(z_t: torch.Tensor, vel: torch.Tensor,
                           timestep: torch.Tensor,
                           num_steps: int = DEFAULT_NUM_STEPS) -> torch.Tensor:
    """The predicted clean sample ``z_t + (1 - t) * vel``."""
    t = timestep_to_time(timestep, num_steps, ndim=z_t.dim())
    return z_t + (1.0 - t) * vel


def euler_start(z0: torch.Tensor, z1: Optional[torch.Tensor],
                start_step: int,
                num_steps: int = DEFAULT_NUM_STEPS) -> torch.Tensor:
    """Initial Euler state: pure noise at ``start_step == num_steps``, else
    the partially noised target ``t0*z1 + (1-t0)*z0``."""
    if start_step >= num_steps:
        return z0
    if z1 is None:
        raise ValueError(
            f"start_step={start_step} < num_steps={num_steps} requires the "
            "target sample z1 to seed the partially-noised start state")
    t0 = (num_steps - start_step) / num_steps
    return t0 * z1 + (1.0 - t0) * z0


def sample_step_sequence(sample_steps: int, start_step: Optional[int] = None,
                         num_steps: int = DEFAULT_NUM_STEPS) -> np.ndarray:
    """``np.linspace(0, start_step, steps+1)[1:]`` as integers, high->low."""
    if start_step is None:
        start_step = num_steps
    seq = np.linspace(0, start_step, num=sample_steps + 1, endpoint=True,
                      dtype=np.int64)[1:]
    return seq[::-1].copy()


def scheduler_step_sequence(sample_steps: int,
                            start_step: Optional[int] = None,
                            num_steps: int = DEFAULT_NUM_STEPS) -> np.ndarray:
    """``np.linspace(0, start_step, steps)`` as integers, high->low (the
    step sequence of the reference's ``RectifiedFlow.sample_loop``)."""
    if start_step is None:
        start_step = num_steps
    seq = np.linspace(0, start_step, num=sample_steps, endpoint=True,
                      dtype=np.int64)
    return seq[::-1].copy()


def euler_sample(velocity_fn: Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor],
                 z0: torch.Tensor, step_seq: Sequence[int]) -> torch.Tensor:
    """Euler-integrate ``velocity_fn(z, timestep)`` from ``z0``."""
    dt = 1.0 / len(step_seq)
    z = z0
    for step in step_seq:
        t = torch.full((z.shape[0],), float(step), dtype=torch.float32,
                       device=z.device)
        z = z + velocity_fn(z, t) * dt
    return z


def heun_sample(velocity_fn: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor],
                z0: torch.Tensor, step_seq: Sequence[int]) -> torch.Tensor:
    """Heun (2nd-order) integration of ``velocity_fn(z, timestep)`` from
    ``z0``: two velocity calls a step, the predictor evaluated at the next
    step of the sequence and, on the last step, at step 0."""
    dt = 1.0 / len(step_seq)
    nxt = list(step_seq[1:]) + [0]
    z = z0

    def at(step):
        return torch.full((z.shape[0],), float(step), dtype=torch.float32,
                          device=z.device)
    for step, step_next in zip(step_seq, nxt):
        v1 = velocity_fn(z, at(step))
        v2 = velocity_fn(z + v1 * dt, at(step_next))
        z = z + dt * 0.5 * (v1 + v2)
    return z
