"""Checkpoint save, rotate, resume and load for inference (port of
``CheckpointManager``, ``load_pretrain_partial`` and the helpers of
``hivae_tpu/training/checkpoint.py``).

Each checkpoint is a ``checkpoint-{step}`` directory holding one
``torch.save`` file of the train state (parameters, optimizer state, EMA and
step); the newest is found by the same ``checkpoint-(\\d+)`` pattern, and
only the ``max_to_keep`` newest are kept. Writes go to a temporary name
first, so a checkpoint directory is either complete or absent. Over a mesh
of ranks the trainer gathers the whole state (FSDP's shards and the
weights split over ``tensor``) to rank 0, which writes this same single
file while the others wait (``AMDTrainer.save``), and each rank keeps its
part when it restores one; so a checkpoint of any mesh
resumes at any other, one card included. (The JAX package writes sharded
Orbax checkpoints instead.)

``save_config``/``load_config`` write and read the model's
``config.json`` beside the checkpoints. For inference,
``load_trained_params`` reads the parameters (or their EMA)
of such a checkpoint and ``load_pretrain_partial`` a reference-named
``.safetensors`` state dict. Orbax checkpoints of the JAX package cannot
be read without JAX and are refused.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..utils.checkpoint_io import load_safetensors

_CKPT_RE = re.compile(r"checkpoint-(\d+)")
STATE_FILE = "state.pt"
# files an Orbax checkpoint directory holds (the JAX package's format)
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt",
                  "checkpoint")


def save_config(config: Dict[str, Any], directory: str,
                name: str = "config.json") -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, name), "w") as f:
        json.dump(config, f, indent=2, default=str)


def load_config(path: str) -> Dict[str, Any]:
    """The config dict of ``path`` (a file, or a directory holding
    ``config.json``)."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    with open(path) as f:
        return json.load(f)


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


def _state_file(path: str) -> str:
    """The ``state.pt`` of a checkpoint directory, or of the newest
    ``checkpoint-{step}`` under ``path``; refuses an Orbax directory."""
    path = find_latest_checkpoint(path) or path
    state = os.path.join(path, STATE_FILE)
    if os.path.isfile(state):
        return state
    if os.path.isdir(path) and any(
            os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{path} is an Orbax checkpoint (the JAX package's format), "
            "which cannot be read without JAX; pass the port trainer's "
            "checkpoint directory or a reference-named .safetensors file")
    raise FileNotFoundError(f"no {STATE_FILE} in {path} or in a "
                            "checkpoint-{step} directory under it")


def load_trained_params(path: str, use_ema: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """The parameters of a trainer checkpoint (a ``checkpoint-{step}``
    directory, or the directory holding them: the newest is read), on the
    CPU. ``use_ema`` takes the EMA of the parameters; a checkpoint trained
    without one falls back to the parameters, with a printed note."""
    state = torch.load(_state_file(path), map_location="cpu",
                       weights_only=True)
    if use_ema:
        if state.get("ema_params") is not None:
            print("using EMA weights")
            return state["ema_params"]
        print("no EMA tree in checkpoint; using live params")
    return state["params"]


def load_pretrain_partial(model: nn.Module, path: str,
                          skip_patterns: tuple = ()) -> Dict[str, list]:
    """Load a reference-named ``.safetensors`` state dict into ``model``
    (``load_state_partial``)."""
    return load_state_partial(model, load_safetensors(path), skip_patterns)


def load_state_partial(model: nn.Module, state: Dict[str, torch.Tensor],
                       skip_patterns: tuple = ()) -> Dict[str, list]:
    """Load a reference-named state dict into ``model`` in place, leaving
    keys that contain any of ``skip_patterns`` (and those ``state`` lacks)
    at their current values. A stride-p patchify convolution (O, I, p, p)
    fills a ``PatchEmbed`` Linear (O, I*p*p): the port's patch layout is
    channel-major, as the convolution's weight flattens. Returns
    {"missing": model keys not loaded, "unused": keys of ``state`` not
    used}."""
    state = {k: v for k, v in state.items()
             if not any(p in k for p in skip_patterns)}
    target = model.state_dict()
    missing, loaded = [], {}
    for key, cur in target.items():
        if key not in state:
            missing.append(key)
            continue
        src = state[key]
        if src.shape != cur.shape:
            if src.dim() == 4 and cur.dim() == 2 and \
                    src.reshape(src.shape[0], -1).shape == cur.shape:
                src = src.reshape(cur.shape)
            else:
                raise ValueError(f"shape mismatch for {key}: file "
                                 f"{tuple(src.shape)} vs model "
                                 f"{tuple(cur.shape)}")
        loaded[key] = src.to(cur.dtype)
    model.load_state_dict(loaded, strict=False)
    return {"missing": missing,
            "unused": [k for k in state if k not in loaded]}
