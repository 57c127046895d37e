"""Small shared utilities (the port's counterparts of ``count_params``,
``print_param_num`` and ``save_args`` of ``hivae_tpu/utils/misc.py``, and
``no_grad``)."""

from __future__ import annotations

import functools
import os

import torch
from torch import nn


def no_grad(fn):
    """``torch.no_grad()`` as a decorator that switches grad mode only where
    it is on. ``torch.export`` records every switch, even to the mode
    already set, as a region of the graph, which it then splits out and
    inlines again, one recompile of the whole graph a region: the serving
    functions that ``cli.export_sampler`` traces (``reconstruct_clip``,
    ``models.amd.sample``, ``models.vae.vae_encode`` and ``vae_decode``)
    take this one (its trace times: ``PERF.md`` §6, PR 14)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        with torch.no_grad():
            return fn(*args, **kwargs)
    return run


def count_params(model: nn.Module) -> int:
    """Total element count of a module's parameters."""
    return sum(p.numel() for p in model.parameters())


def print_param_num(name: str, model: nn.Module) -> int:
    n = count_params(model)
    print(f"* {name}: {n/1e6:.1f}M parameters")
    return n


def save_args(args, directory: str, name: str = "args.txt") -> None:
    """Write a CLI's parsed arguments, one ``key: value`` a line, beside
    its checkpoints."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, name), "w") as f:
        for k, v in sorted(vars(args).items()):
            f.write(f"{k}: {v}\n")
