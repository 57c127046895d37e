"""Checkpoint save, rotate and resume (port of ``CheckpointManager`` and
the helpers of ``hivae_tpu/training/checkpoint.py``).

Each checkpoint is a ``checkpoint-{step}`` directory holding one
``torch.save`` file of the train state (parameters, optimizer state, EMA and
step); the newest is found by the same ``checkpoint-(\\d+)`` pattern, and
only the ``max_to_keep`` newest are kept. Writes go to a temporary name
first, so a checkpoint directory is either complete or absent. Orbax
checkpoints of the JAX package are not read.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

_CKPT_RE = re.compile(r"checkpoint-(\d+)")
STATE_FILE = "state.pt"


def find_latest_checkpoint(directory: str) -> Optional[str]:
    """Newest ``checkpoint-{step}`` subdirectory, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in map(_CKPT_RE.fullmatch,
                                          os.listdir(directory)) if m]
    return os.path.join(directory, f"checkpoint-{max(steps)}") if steps \
        else None


def checkpoint_step(path: str) -> int:
    m = _CKPT_RE.search(os.path.basename(os.path.normpath(path)))
    return int(m.group(1)) if m else 0


class CheckpointManager:
    """Rotating ``torch.save`` checkpointer for train-state dicts."""

    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, state: Dict[str, Any]) -> str:
        path = os.path.join(self.directory, f"checkpoint-{step}")
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        self._rotate()
        return path

    def restore(self, path: Optional[str] = None,
                map_location: Any = None) -> Dict[str, Any]:
        path = path or find_latest_checkpoint(self.directory)
        if path is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(os.path.join(path, STATE_FILE),
                          map_location=map_location, weights_only=True)

    def latest_step(self) -> Optional[int]:
        path = find_latest_checkpoint(self.directory)
        return checkpoint_step(path) if path else None

    def _rotate(self) -> None:
        steps = sorted(int(m.group(1)) for m in map(
            _CKPT_RE.fullmatch, os.listdir(self.directory)) if m)
        for s in (steps[:-self.max_to_keep] if self.max_to_keep else []):
            shutil.rmtree(os.path.join(self.directory, f"checkpoint-{s}"),
                          ignore_errors=True)
