"""Reading ``.safetensors`` files without the ``safetensors`` package, and
the old diffusers SD-VAE key names (the port's counterparts of
``load_safetensors`` and ``normalize_vae_keys`` of
``hivae_tpu/utils/torch_convert.py``).

The format: an 8-byte little-endian header length N, N bytes of JSON
mapping each tensor's name to its ``dtype``, ``shape`` and ``data_offsets``
(begin, end) into the byte buffer that follows, whose values are raw
little-endian (an optional ``__metadata__`` entry holds strings).
"""

from __future__ import annotations

import json
import struct
import sys
from typing import Dict

import numpy as np
import torch

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor} (bf16 included)."""
    if sys.byteorder != "little":
        raise RuntimeError("load_safetensors reads little-endian data on a "
                           "little-endian host only")
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = np.fromfile(f, dtype=np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{info['dtype']}")
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= data.size:
            raise ValueError(f"{path}: {name} lies outside the file")
        dtype = _DTYPES[info["dtype"]]
        if begin == end:  # an empty tensor
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = torch.from_numpy(data[begin:end].copy())
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


# old diffusers SD-VAE attention names -> the current ones
_VAE_ATTN_ALIASES = [("query", "to_q"), ("key", "to_k"), ("value", "to_v"),
                     ("proj_attn", "to_out.0")]


def normalize_vae_keys(state: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """An SD-VAE state dict with the old diffusers attention names (and
    their projections stored as (C, C, 1, 1) convolutions) -> the current
    names and (C, C) projections."""
    out = {}
    for k, v in state.items():
        for old, new in _VAE_ATTN_ALIASES:
            k = k.replace(f".{old}.", f".{new}.")
        if any(s in k for s in ("to_q", "to_k", "to_v", "to_out.0")) and \
                "weight" in k and v.dim() == 4 and v.shape[2:] == (1, 1) and \
                ("encoder" in k or "decoder" in k):
            v = v[:, :, 0, 0]
        out[k] = v
    return out
