"""Small shared utilities (the port's counterparts of ``count_params``,
``print_param_num`` and ``save_args`` of ``hivae_tpu/utils/misc.py``)."""

from __future__ import annotations

import os

from torch import nn


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
