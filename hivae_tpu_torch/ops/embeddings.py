"""Sin-cos positional and timestep embeddings (port of
``hivae_tpu/ops/embeddings.py``; diffusers formulas).

Position tables are numpy constants built once per shape; the timestep
embedding is a tensor function.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def timestep_embedding(timesteps: torch.Tensor,
                       embedding_dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding matching diffusers ``Timesteps`` as
    the models use it (flip_sin_to_cos, no frequency shift, max period
    10000): (N,) -> (N, embedding_dim) fp32."""
    half_dim = embedding_dim // 2
    exponent = -np.log(10000) * np.arange(half_dim, dtype=np.float32)
    exponent = exponent / half_dim
    freqs = torch.from_numpy(np.exp(exponent)).to(timesteps.device)
    emb = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def _sincos_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """1-D sincos table from positions: cat[sin(p*w), cos(p*w)]."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


@lru_cache(maxsize=64)
def get_1d_sincos_pos_embed(embed_dim: int, length: int) -> np.ndarray:
    """(length, embed_dim) float32 table."""
    return _sincos_from_grid(embed_dim, np.arange(length)).astype(np.float32)


@lru_cache(maxsize=64)
def get_2d_sincos_pos_embed(embed_dim: int,
                            grid_size: Tuple[int, int]) -> np.ndarray:
    """(h*w, embed_dim) table, row-major over (h, w); the first channel
    half encodes the w coordinate, as diffusers does."""
    assert embed_dim % 2 == 0
    h, w = grid_size
    grid = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    grid = np.stack(grid, axis=0).reshape([2, 1, h, w])
    emb_h = _sincos_from_grid(embed_dim // 2, grid[0])
    emb_w = _sincos_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


@lru_cache(maxsize=64)
def get_3d_sincos_pos_embed(embed_dim: int, spatial_size: Tuple[int, int],
                            temporal_size: int,
                            spatial_interpolation_scale: float = 1.0,
                            temporal_interpolation_scale: float = 1.0
                            ) -> np.ndarray:
    """(T, H*W, embed_dim) table as diffusers' ``get_3d_sincos_pos_embed``:
    the first quarter of the channels encodes time, the rest the 2-D
    position (``spatial_size`` is (w, h))."""
    assert embed_dim % 4 == 0
    w, h = spatial_size
    dim_spatial, dim_temporal = 3 * embed_dim // 4, embed_dim // 4
    grid = np.meshgrid(
        np.arange(w, dtype=np.float64) / spatial_interpolation_scale,
        np.arange(h, dtype=np.float64) / spatial_interpolation_scale)
    grid = np.stack(grid, axis=0).reshape([2, 1, h, w])
    pos_spatial = np.concatenate(
        [_sincos_from_grid(dim_spatial // 2, grid[0]),
         _sincos_from_grid(dim_spatial // 2, grid[1])], axis=1)
    pos_temporal = _sincos_from_grid(
        dim_temporal, np.arange(temporal_size, dtype=np.float64)
        / temporal_interpolation_scale)
    pos_spatial = np.repeat(pos_spatial[np.newaxis], temporal_size, axis=0)
    pos_temporal = np.repeat(pos_temporal[:, np.newaxis], h * w, axis=1)
    return np.concatenate([pos_temporal, pos_spatial],
                          axis=-1).astype(np.float32)
