"""Optimizer and train state of the port (port of ``make_optimizer`` and
``TrainState`` of ``hivae_tpu/training/train_state.py``).

``AdamW`` mirrors the optax chain the JAX package builds, step for step:

* ``clip_by_global_norm(max_norm)``: the gradients are scaled by
  ``max_norm / norm`` only when ``norm >= max_norm``, as ``(g / norm) *
  max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and
  is not used);
* ``adamw``: bias-corrected moments, ``mu_dtype`` for the first moment only
  (``torch.bfloat16`` stores mu in bf16 after each update, as optax casts
  it), decoupled weight decay on every parameter, the update scaled by
  ``-lr`` from the schedule at optax's count (0 on the first step, so a
  warm-up starts at lr 0);
* ``MultiSteps(every_k=accumulate_steps)``: the running mean of k
  gradients, one inner update every k calls and a zero update otherwise.

Schedules: ``constant`` (with an optional linear warm-up from 0) and
``cosine`` (optax ``warmup_cosine_decay_schedule`` from 0 to 0), evaluated in
fp32 as optax evaluates them. The parameters are updated in place (the JAX
package's state is immutable and its step donates the buffers instead).

Sharded parameters (DTensors: FSDP2's over the mesh's ``fsdp`` axis,
weight tensor parallelism's over ``tensor``, or both): the optimizer, the
moments and the EMA live on each rank's local shards
(``parallel.sharding.local``), and ``global_norm`` adds each tensor's sum
of squares over the groups of the mesh axes its parameter is split on
(a replicated parameter counted once) before the square root, so the clip
decision and the trainer's finite check come out the same on every rank.
``full_state_dict`` gathers the whole state to rank 0's host memory for a
checkpoint and ``load_state_dict`` takes whole tensors and keeps this
rank's part.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..parallel.sharding import gather_to_first, local, part_of

_F = np.float32


def make_schedule(learning_rate: float, warmup_steps: int = 0,
                  total_steps: Optional[int] = None,
                  schedule: str = "constant") -> Callable[[int], float]:
    """count -> learning rate, in fp32 as optax computes it."""

    def linear(count, steps):
        c = _F(min(max(count, 0), steps))
        frac = _F(1) - c / _F(steps)
        return _F(0.0 - learning_rate) * frac + _F(learning_rate)

    if schedule == "constant":
        if warmup_steps <= 0:
            return lambda count: float(_F(learning_rate))
        return lambda count: float(
            linear(count, warmup_steps) if count < warmup_steps
            else _F(learning_rate))
    if schedule == "cosine":
        decay = float((total_steps or 10 ** 6) - warmup_steps)

        def cosine(count):
            if count < warmup_steps:
                return float(linear(count, warmup_steps))
            c = _F(min(count - warmup_steps, decay))
            cos = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * c / _F(decay)))
            return float(_F(learning_rate) * cos)
        return cosine
    raise ValueError(schedule)


def _split_axes(like) -> tuple:
    """The mesh dims whose ``Shard`` placements split the DTensor
    ``like``; () for a plain (replicated) tensor."""
    mesh = getattr(like, "device_mesh", None)
    if mesh is None:
        return ()
    return tuple(m for m, pl in enumerate(like.placements) if pl.is_shard())


def mesh_sum(values: List[torch.Tensor], likes) -> torch.Tensor:
    """The sum over the mesh of ``values`` (one 0-d or 1-d tensor for each
    tensor of ``likes``, computed on this rank's part of it): the values of
    a tensor split over mesh axes are added over those axes' groups, those
    of a replicated one are counted once. Every rank of the mesh must call
    it."""
    sums = {}   # mesh axis names -> (groups, [values])
    for v, like in zip(values, likes):
        dims = _split_axes(like)
        key = tuple(like.device_mesh.mesh_dim_names[m] for m in dims) \
            if dims else ()
        groups = [like.device_mesh.get_group(m) for m in dims]
        sums.setdefault(key, (groups, []))[1].append(v)
    total = None
    for key in sorted(sums):
        groups, parts = sums[key]
        part = torch.stack(parts).sum(0)
        if groups:
            from ..parallel import comm

            for g in groups:
                comm.all_reduce_([part], g)
        total = part if total is None else total + part
    return total


def global_norm(tensors: List[torch.Tensor], likes=None) -> torch.Tensor:
    """sqrt of the sum of squares over every element, fp32 (optax
    ``global_norm``). The tensors may be this rank's parts in the layouts
    of ``likes`` (by default the tensors themselves): ``mesh_sum`` adds a
    split tensor's sum of squares over the axes it is split on and counts
    a replicated one once. Every rank of the mesh must call it."""
    likes = tensors if likes is None else likes
    return torch.sqrt(mesh_sum([local(t).float().square().sum()
                                for t in tensors], likes))


class AdamW:
    """The JAX package's ``make_optimizer`` over a list of fp32 parameters.
    ``step(grads)`` applies one update in place."""

    def __init__(self, params: List[torch.Tensor], learning_rate: float = 1e-4,
                 warmup_steps: int = 0, total_steps: Optional[int] = None,
                 schedule: str = "constant", weight_decay: float = 1e-2,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 max_grad_norm: float = 1.0, accumulate_steps: int = 1,
                 mu_dtype: Optional[torch.dtype] = None):
        # the parameters as given (DTensors where sharded) and their local
        # parts, which the update writes in place
        self.shards = list(params)
        self.params = [local(p) for p in self.shards]
        self.lr = make_schedule(learning_rate, warmup_steps, total_steps,
                                schedule)
        self.weight_decay, self.b1, self.b2, self.eps = (weight_decay, b1,
                                                         b2, eps)
        self.max_grad_norm = max_grad_norm
        self.k = accumulate_steps
        self.count = 0          # inner (optax) update count
        self.mini_step = 0      # MultiSteps position within k
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.k > 1 else None)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        grads = [local(g).float() for g in grads]
        if self.k > 1:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            if n < self.k - 1:
                self.mini_step += 1
                return
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
        self._update(grads)

    def _update(self, grads):
        norm = global_norm(grads, self.shards)
        if not bool(norm < self.max_grad_norm):
            grads = [(g / norm) * self.max_grad_norm for g in grads]
        lr = self.lr(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1 = float(_F(1) - _F(b1) ** _F(self.count))
        bc2 = float(_F(1) - _F(b2) ** _F(self.count))
        for i, (p, g) in enumerate(zip(self.params, grads)):
            # (1 - b1) * g + b1 * mu with b1 rounded to mu's dtype and the
            # product in it, as a weakly typed scalar behaves in JAX
            b1_t = torch.tensor(b1, dtype=self.mu[i].dtype, device=g.device)
            mu = (1 - b1) * g + self.mu[i] * b1_t
            nu = (1 - b2) * torch.square(g) + b2 * self.nu[i]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = (u + self.weight_decay * p) * (-lr)
            p.add_(u.to(p.dtype))
            self.mu[i] = mu.to(self.mu[i].dtype)
            self.nu[i] = nu

    def state_dict(self) -> Dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    def full_state_dict(self) -> Optional[Dict]:
        """``state_dict`` with every moment whole, on rank 0 (gathered into
        its host memory where the parameters are sharded); None on the
        other ranks. Every rank must call it."""
        def whole(parts):
            return None if parts is None else [
                gather_to_first(t, p) for t, p in zip(parts, self.shards)]
        state = {"count": self.count, "mini_step": self.mini_step,
                 "mu": whole(self.mu), "nu": whole(self.nu),
                 "acc": whole(self.acc)}
        return state if _first() else None

    def load_state_dict(self, state: Dict) -> None:
        """Load a state of whole tensors; this rank keeps its part."""
        self.count, self.mini_step = state["count"], state["mini_step"]
        for name in ("mu", "nu", "acc"):
            if state[name] is not None:
                for dst, src, p in zip(getattr(self, name), state[name],
                                       self.shards):
                    dst.copy_(_part(src, dst, p))


def _first() -> bool:
    """True on rank 0, or in a process with no process group."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _part(whole: torch.Tensor, dst: torch.Tensor,
          like: torch.Tensor) -> torch.Tensor:
    """This rank's part of the whole tensor ``whole`` in ``like``'s layout,
    on ``dst``'s device."""
    return part_of(whole.to(dst.device), like)


def make_optimizer(params: List[torch.Tensor], learning_rate: float = 1e-4,
                   warmup_steps: int = 0, total_steps: Optional[int] = None,
                   schedule: str = "constant", weight_decay: float = 1e-2,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   max_grad_norm: float = 1.0, accumulate_steps: int = 1,
                   mu_dtype: Optional[torch.dtype] = None) -> AdamW:
    """The JAX package's ``make_optimizer`` signature, over ``params``
    (DTensors where sharded: ``global_norm`` reads their layouts)."""
    return AdamW(params, learning_rate, warmup_steps, total_steps, schedule,
                 weight_decay, b1, b2, eps, max_grad_norm, accumulate_steps,
                 mu_dtype)


class TrainState:
    """Step count, the trained parameters (by name, updated in place), the
    optimizer and the optional EMA of the parameters."""

    def __init__(self, params: Dict[str, torch.Tensor], tx: AdamW,
                 ema_decay: float = 0.0):
        self.step = 0
        self.params = params
        self.tx = tx
        self.ema_decay = ema_decay
        self.ema_params = ({k: local(p).detach().clone()
                            for k, p in params.items()}
                           if ema_decay > 0 else None)

    @torch.no_grad()
    def apply_gradients(self, grads: List[torch.Tensor]) -> None:
        self.tx.step(grads)
        if self.ema_params is not None:
            d = self.ema_decay
            for k, p in self.params.items():
                e = self.ema_params[k]
                e.copy_(e * d + local(p).to(e.dtype) * (1.0 - d))
        self.step += 1

    def state_dict(self) -> Dict:
        """This rank's state (on one rank: all of it)."""
        return {"step": self.step,
                "params": {k: local(p).detach()
                           for k, p in self.params.items()},
                "opt_state": self.tx.state_dict(),
                "ema_params": self.ema_params}

    @torch.no_grad()
    def full_state_dict(self) -> Optional[Dict]:
        """The whole state on rank 0: ``state_dict`` with every sharded
        tensor gathered into rank 0's host memory, one tensor at a time, so
        no rank holds more device memory than its part; None on the other
        ranks. Every rank must call it."""
        ema = self.ema_params
        state = {"step": self.step,
                 "params": {k: gather_to_first(local(p).detach(), p)
                            for k, p in self.params.items()},
                 "opt_state": self.tx.full_state_dict(),
                 "ema_params": None if ema is None else {
                     k: gather_to_first(e, self.params[k])
                     for k, e in ema.items()}}
        return state if _first() else None

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Load a whole state (``full_state_dict``'s, or one rank's of an
        unsharded run); each rank keeps its part."""
        self.step = state["step"]
        for k, p in self.params.items():
            dst = local(p)
            dst.copy_(_part(state["params"][k], dst, p))
        self.tx.load_state_dict(state["opt_state"])
        if self.ema_params is not None:
            for k, e in self.ema_params.items():
                e.copy_(_part(state["ema_params"][k], e, self.params[k]))
