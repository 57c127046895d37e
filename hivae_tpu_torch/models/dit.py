"""Velocity DiT of AMD_N (port of ``VelocityDiTImgSpatialTempMotion`` and
the ``_DiTBase`` head of ``hivae_tpu/models/dit.py``), layers unrolled.

Each layer runs an object joint block ([10 motion tokens, 256 patches] at
the flagship: full-block kernel), a camera joint block ([256 site tokens,
256 patches]: full-block kernel) and a per-pixel temporal ``DiTBlock``
(S = frames: plain attention).

``remat=True`` (with ``remat_policy='full'``) is the counterpart of the JAX
package's ``nn.remat(_SpatialTempLayer)``: under autograd each layer of the
loop runs inside ``torch.utils.checkpoint`` (non-reentrant), which keeps only
the layer's inputs and recomputes the rest in the backward. Without grad
(serving) the layers run directly.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import embeddings as emb_ops
from .blocks import (AdaLayerNorm, DiTBlock, JointTransformerBlock, PatchEmbed,
                     TimestepEmbedding)


def unpatchify(tokens: torch.Tensor, height: int, width: int, patch: int,
               channels: int) -> torch.Tensor:
    """(N, h*w, p*p*C) -> (N, C, H, W), inverse of PatchEmbed's layout."""
    n = tokens.shape[0]
    hp, wp = height // patch, width // patch
    x = tokens.reshape(n, hp, wp, channels, patch, patch)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(n, channels, height, width)


def _pos2d(hidden: int, h: int, w: int, p: int) -> torch.Tensor:
    return torch.from_numpy(
        emb_ops.get_2d_sincos_pos_embed(hidden, (h // p, w // p)).copy())[None]


def _pos1d(hidden: int, length: int) -> torch.Tensor:
    return torch.from_numpy(
        emb_ops.get_1d_sincos_pos_embed(hidden, length).copy())[None]


class VelocityDiTImgSpatialTempMotion(nn.Module):
    """Object joint block + camera joint block + per-pixel temporal block
    per layer; camera motion arrives as (n, T, S, Dc) per-site tokens."""

    def __init__(self, heads: int = 20, head_dim: int = 64,
                 out_channels: int = 4, num_layers: int = 12,
                 image_height: int = 32, image_width: int = 32,
                 image_patch_size: int = 2, image_in_channels: int = 4,
                 motion_token_num: int = 12, time_embed_dim: int = 512,
                 use_camera: bool = True, use_object: bool = True,
                 camera_motion_in_channels: int = 16,
                 object_motion_in_channels: int = 64,
                 motion_target_num_frame: int = 16, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        self.remat, self.remat_policy = remat, remat_policy
        hidden = heads * head_dim
        self.hidden, self.heads, self.head_dim = hidden, heads, head_dim
        self.out_channels, self.patch = out_channels, image_patch_size
        self.frames = motion_target_num_frame
        self.time_embedding = TimestepEmbedding(hidden, time_embed_dim)
        self.image_patch_embed = PatchEmbed(image_patch_size,
                                            image_in_channels, hidden)
        self.register_buffer("pos2d", _pos2d(hidden, image_height, image_width,
                                             image_patch_size),
                             persistent=False)
        self.register_buffer("tpos", _pos1d(hidden, motion_target_num_frame),
                             persistent=False)

        def blocks(cls):
            return nn.ModuleList([cls(hidden, heads, head_dim, time_embed_dim)
                                  for _ in range(num_layers)])

        if use_camera:
            self.camera_motion_patch_embed = nn.Linear(
                camera_motion_in_channels, hidden)
            self.camera_transformer_blocks = blocks(JointTransformerBlock)
        if use_object:
            self.object_motion_patch_embed = nn.Linear(
                object_motion_in_channels, hidden)
            self.source_token = nn.Parameter(torch.zeros(1, 1, hidden))
            self.target_token = nn.Parameter(torch.zeros(1, 1, hidden))
            self.object_transformer_blocks = blocks(JointTransformerBlock)
        self.spatial_blocks = blocks(DiTBlock)
        self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
        self.norm_out = AdaLayerNorm(hidden, time_embed_dim)
        self.proj_out = nn.Linear(hidden, image_patch_size ** 2 * out_channels)

    def forward(self, image_hidden_states, timestep,
                camera_motion_target=None, object_motion_source=None,
                object_motion_target=None, camera_site_mask=None):
        n_t, _, hi, wi = image_hidden_states.shape
        t = self.frames
        n = n_t // t
        hidden = self.hidden
        s = hi * wi // self.patch ** 2

        emb = self.time_embedding(timestep)
        # per-spatial-site emb: each clip's first-frame emb over its sites
        emb_s = emb.reshape(n, t, -1)[:, 0:1, :].expand(n, s, emb.shape[-1])
        emb_s = emb_s.reshape(n * s, -1)

        img = self.image_patch_embed(image_hidden_states) + self.pos2d
        img = img.reshape(n, t, s, hidden) + self.tpos[:, :, None]
        img = img.reshape(n_t, s, hidden)

        cam = cam_mask = None
        if camera_motion_target is not None:
            nc, tc, sc, dc = camera_motion_target.shape
            cam = self.camera_motion_patch_embed(
                camera_motion_target.reshape(nc * tc, sc, dc))
            if camera_site_mask is not None:  # (n, sc) per clip -> per frame
                cam_mask = camera_site_mask.repeat_interleave(tc, dim=0)

        motion = None
        if object_motion_source is not None:
            msl = 2 * object_motion_target.shape[1] + 2
            src = self.source_token.expand(n_t, 1, hidden)
            tgt = self.target_token.expand(n_t, 1, hidden)
            motion = torch.cat(
                [src, self.object_motion_patch_embed(object_motion_source),
                 tgt, self.object_motion_patch_embed(object_motion_target)],
                dim=1)
            motion = motion + _pos1d(hidden, msl).to(motion)

        remat = self.remat and torch.is_grad_enabled()
        if remat and self.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy {self.remat_policy!r} is not ported; only "
                "'full' is")
        for i in range(len(self.spatial_blocks)):
            args = (i, motion, cam, img, emb, emb_s, cam_mask)
            if remat:
                motion, cam, img = checkpoint(self._layer, *args,
                                              use_reentrant=False)
            else:
                motion, cam, img = self._layer(*args)
        return self._head(img, emb, hi, wi)

    def _layer(self, i, motion, cam, img, emb, emb_s, cam_mask):
        """Layer i: object joint, camera joint, per-pixel temporal block."""
        n_t, s, hidden = img.shape
        t = self.frames
        n = n_t // t
        if motion is not None:
            motion, img = self.object_transformer_blocks[i](motion, img, emb)
        if cam is not None:
            cam, img = self.camera_transformer_blocks[i](
                cam, img, emb, hidden_key_mask=cam_mask)
        img = img.reshape(n, t, s, hidden).transpose(1, 2).reshape(
            n * s, t, hidden)
        img = self.spatial_blocks[i](img, emb_s)
        img = img.reshape(n, s, t, hidden).transpose(1, 2).reshape(
            n_t, s, hidden)
        return motion, cam, img

    def _head(self, img_tokens, emb, height, width):
        x = self.norm_out(self.norm_final(img_tokens), emb)
        return unpatchify(self.proj_out(x), height, width, self.patch,
                          self.out_channels)
