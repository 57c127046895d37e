"""Motion encoders of AMD_N (port of ``hivae_tpu/models/motion_encoders.py``):

  * ``MotionEncoderSpatial`` - object branch: learnable motion tokens
    prepended to each frame's patch tokens, N self-attention layers, tokens
    projected out. At the flagship's 4 + 256 tokens its attention runs the
    full-block kernel.
  * ``MotionEncoderSpatialTemporal`` - the dual-encoder ``AMDModel``'s
    encoder: as the spatial one over cat(reference frames, target frames)
    on T, and after each block a ``MotionTemporalBlock`` mixes each target
    token over the target half's frames (S = T/2: plain attention). At
    AMD_S widths each block attends over 12 + 256 tokens (full-block
    kernel).
  * ``MotionEncoderTemporalCross`` - camera branch: per-site temporal
    query tokens cross-attend to the per-pixel temporal tubes (S = frames).
  * ``MotionSequenceTransformer`` - self-attention over a clip's flattened
    F x L motion tokens (64 at the flagship: plain attention), for a model
    with ``need_motion_transformer``.

Token masking has the JAX package's two branches. A ratio given as a 0-d
tensor is the training path's per-step jitter: tokens are shuffled at full
length and the dropped ones are hidden as attention keys
(``shuffle_mask_tokens``). A Python float is the serving knob: a random
subset of ``int(L * (1 - ratio))`` tokens is kept and the rest dropped, so
the sequence gets shorter (``random_mask_tokens``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..ops import embeddings as emb_ops
from .blocks import (BasicCrossTransformerBlock, BasicTransformerBlock,
                     MotionTemporalBlock, PatchEmbed)


def _table(arr) -> torch.Tensor:
    return torch.from_numpy(arr.copy())


def shuffle_mask_tokens(x: torch.Tensor, mask_ratio: torch.Tensor,
                        axis: int = 1, *, perm: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """Per-sample shuffle of ``x`` along ``axis`` (full length kept) and a
    keep-mask over the first ``floor(L * (1 - ratio))`` slots, the ratio a
    0-d fp32 tensor. ``perm`` (N, L) is the permutation; without it one is
    drawn as the argsort of uniform noise from ``generator``, as the JAX
    package draws it. Returns (x_shuffled, keep (N, L) bool)."""
    n, length = x.shape[0], x.shape[axis]
    if perm is None:
        noise = torch.rand((n, length), generator=generator, device=x.device)
        perm = torch.argsort(noise, dim=1, stable=True)
    idx = perm.to(x.device).reshape((n,) + (1,) * (axis - 1) + (length,) +
                                    (1,) * (x.dim() - axis - 1))
    x = torch.take_along_dim(x, idx, dim=axis)
    ratio = torch.as_tensor(mask_ratio, dtype=torch.float32, device=x.device)
    len_keep = torch.floor(length * (1.0 - ratio))
    keep = torch.arange(length, device=x.device)[None, :] < len_keep
    return x, keep.expand(n, length)


def random_mask_tokens(x: torch.Tensor, mask_ratio: float, axis: int = 1,
                       *, u: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Keep ``int(L * (1 - mask_ratio))`` of the L tokens along ``axis`` of
    ``x``, a random subset per sample in the order of a stable argsort of
    the uniform draw ``u`` (N, L) (drawn from ``generator`` when not
    given). Returns the kept tokens only."""
    n, length = x.shape[0], x.shape[axis]
    len_keep = int(length * (1 - mask_ratio))
    if u is None:
        u = torch.rand((n, length), generator=generator, device=x.device)
    keep = torch.argsort(u.to(x.device), dim=1, stable=True)[:, :len_keep]
    idx = keep.reshape((n,) + (1,) * (axis - 1) + (len_keep,) +
                       (1,) * (x.dim() - axis - 1))
    return torch.take_along_dim(x, idx, dim=axis)


class MotionEncoderSpatial(nn.Module):
    """(N, T, C, H, W) -> motion tokens (N, T, L, motion_channel)."""

    def __init__(self, img_height: int = 32, img_width: int = 32,
                 img_inchannel: int = 4, img_patch_size: int = 2,
                 motion_token_num: int = 12, motion_channel: int = 128,
                 need_norm_out: bool = True, heads: int = 12,
                 head_dim: int = 64, num_layers: int = 8):
        super().__init__()
        hidden = heads * head_dim
        self.motion_token_num, self.motion_channel = motion_token_num, motion_channel
        self.motion_token = nn.Parameter(
            0.02 * torch.randn(1, motion_token_num, motion_channel))
        self.motion_embed = nn.Linear(motion_channel, hidden)
        self.patch_embed = PatchEmbed(img_patch_size, img_inchannel, hidden)
        grid = (img_height // img_patch_size, img_width // img_patch_size)
        self.register_buffer(
            "pos", _table(emb_ops.get_2d_sincos_pos_embed(hidden, grid))[None],
            persistent=False)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(hidden, heads, head_dim)
             for _ in range(num_layers)])
        self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
        self.proj_out = nn.Linear(hidden, motion_channel)
        self.norm_out = (nn.LayerNorm(motion_channel, eps=1e-5,
                                      elementwise_affine=False)
                         if need_norm_out else nn.Identity())

    def forward(self, video: torch.Tensor,
                mask_ratio: Optional[Union[float, torch.Tensor]] = None, *,
                perm: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A 0-d tensor ``mask_ratio`` shuffles the patch tokens (``perm``
        (N*T, L) or drawn from ``generator``) and hides the dropped ones as
        attention keys; a float drops them (``u`` (N*T, L) the uniform draw
        that orders them, or drawn from ``generator``)."""
        n, t, c, h, w = video.shape
        mtok = self.motion_embed(self.motion_token)
        mtok = mtok.expand(n * t, -1, -1)
        x = self.patch_embed(video.reshape(n * t, c, h, w)) + self.pos
        key_mask = None
        if torch.is_tensor(mask_ratio):
            x, keep = shuffle_mask_tokens(x, mask_ratio, perm=perm,
                                          generator=generator)
            key_mask = torch.cat(
                [torch.ones((n * t, self.motion_token_num), dtype=torch.bool,
                            device=x.device), keep], dim=1)
        elif mask_ratio is not None:
            x = random_mask_tokens(x, mask_ratio, u=u, generator=generator)
        hstate = torch.cat([mtok, x], dim=1)
        for blk in self.transformer_blocks:
            hstate = blk(hstate, key_mask)
        mtok = self.norm_final(hstate[:, :self.motion_token_num])
        mtok = self.norm_out(self.proj_out(mtok))
        return mtok.reshape(n, t, self.motion_token_num, self.motion_channel)


class MotionEncoderSpatialTemporal(nn.Module):
    """(N, 2T', C, H, W) = cat(reference frames, target frames) on T ->
    motion tokens (N, 2T', L, motion_channel). The target half's tokens
    carry a 1-D position over ``video_frames * L`` entries, and each
    self-attention block is followed by a ``MotionTemporalBlock`` over the
    target half's frames, one sequence a token."""

    def __init__(self, img_height: int = 32, img_width: int = 32,
                 img_inchannel: int = 4, img_patch_size: int = 2,
                 motion_token_num: int = 12, motion_channel: int = 128,
                 need_norm_out: bool = True, video_frames: int = 16,
                 heads: int = 12, head_dim: int = 64, num_layers: int = 8):
        super().__init__()
        hidden = heads * head_dim
        self.hidden = hidden
        self.motion_token_num, self.motion_channel = motion_token_num, motion_channel
        self.motion_token = nn.Parameter(
            0.02 * torch.randn(1, motion_token_num, motion_channel))
        self.motion_embed = nn.Linear(motion_channel, hidden)
        self.patch_embed = PatchEmbed(img_patch_size, img_inchannel, hidden)
        grid = (img_height // img_patch_size, img_width // img_patch_size)
        self.register_buffer(
            "pos", _table(emb_ops.get_2d_sincos_pos_embed(hidden, grid))[None],
            persistent=False)
        self.register_buffer(
            "tpos", _table(emb_ops.get_1d_sincos_pos_embed(
                hidden, video_frames * motion_token_num))[None],
            persistent=False)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(hidden, heads, head_dim)
             for _ in range(num_layers)])
        self.motion_blocks = nn.ModuleList(
            [MotionTemporalBlock(hidden, heads, head_dim)
             for _ in range(num_layers)])
        self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
        self.proj_out = nn.Linear(hidden, motion_channel)
        self.norm_out = (nn.LayerNorm(motion_channel, eps=1e-5,
                                      elementwise_affine=False)
                         if need_norm_out else nn.Identity())

    def forward(self, video: torch.Tensor,
                mask_ratio: Optional[Union[float, torch.Tensor]] = None, *,
                perm: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Masking as ``MotionEncoderSpatial``'s, over the patch tokens of
        every frame (``perm``/``u`` (N*2T', patches))."""
        n, t, c, h, w = video.shape
        half, ltok, hidden = t // 2, self.motion_token_num, self.hidden
        mtok = self.motion_embed(self.motion_token)[None].expand(
            n, t, ltok, hidden)
        src, tgt = mtok[:, :half], mtok[:, half:]
        tgt = (tgt.reshape(n, half * ltok, hidden) +
               self.tpos[:, :half * ltok]).reshape(n, half, ltok, hidden)
        mtok = torch.cat([src, tgt], dim=1).reshape(n * t, ltok, hidden)
        x = self.patch_embed(video.reshape(n * t, c, h, w)) + self.pos
        key_mask = None
        if torch.is_tensor(mask_ratio):
            x, keep = shuffle_mask_tokens(x, mask_ratio, perm=perm,
                                          generator=generator)
            key_mask = torch.cat(
                [torch.ones((n * t, ltok), dtype=torch.bool,
                            device=x.device), keep], dim=1)
        elif mask_ratio is not None:
            x = random_mask_tokens(x, mask_ratio, u=u, generator=generator)
        hstate = torch.cat([mtok, x], dim=1)
        for blk, temporal in zip(self.transformer_blocks, self.motion_blocks):
            hstate = blk(hstate, key_mask)
            mtok = hstate[:, :ltok].reshape(n, t, ltok, hidden)
            src, tgt = mtok[:, :half], mtok[:, half:]
            tt = tgt.transpose(1, 2).reshape(n * ltok, half, hidden)
            tgt = temporal(tt).reshape(n, ltok, half, hidden).transpose(1, 2)
            mtok = torch.cat([src, tgt], dim=1).reshape(n * t, ltok, hidden)
            hstate = torch.cat([mtok, hstate[:, ltok:]], dim=1)
        mtok = self.norm_out(self.proj_out(self.norm_final(hstate[:, :ltok])))
        return mtok.reshape(n, t, ltok, self.motion_channel)


class MotionEncoderTemporalCross(nn.Module):
    """(N, T, C, H, W) low-pass video -> camera tokens (N, T, S, channel),
    one token per spatial site per frame; with a 0-d tensor ``mask_ratio``
    -> (tokens, site_keep (N, S) bool), the sites shuffled; with a float,
    only the kept sites' tokens (S = int(sites * (1 - ratio)))."""

    def __init__(self, img_height: int = 32, img_width: int = 32,
                 img_inchannel: int = 4, img_patch_size: int = 2,
                 motion_token_num: int = 12, motion_channel: int = 128,
                 need_norm_out: bool = True, video_frames: int = 16,
                 heads: int = 12, head_dim: int = 64, num_layers: int = 8):
        super().__init__()
        hidden = heads * head_dim
        self.hidden = hidden
        self.motion_token_num, self.motion_channel = motion_token_num, motion_channel
        self.patch_embed = PatchEmbed(img_patch_size, img_inchannel, hidden)
        grid = (img_height // img_patch_size, img_width // img_patch_size)
        self.register_buffer(
            "spos", _table(emb_ops.get_2d_sincos_pos_embed(hidden, grid))[None],
            persistent=False)
        self.register_buffer(
            "tpos", _table(emb_ops.get_1d_sincos_pos_embed(hidden, video_frames)),
            persistent=False)
        self.motion_token = nn.Parameter(
            0.02 * torch.randn(1, motion_token_num, motion_channel))
        self.motion_embed = nn.Linear(motion_channel, hidden)
        self.transformer_blocks = nn.ModuleList(
            [BasicCrossTransformerBlock(hidden, heads, head_dim)
             for _ in range(num_layers)])
        self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
        self.proj_out = nn.Linear(hidden, motion_channel)
        self.norm_out = (nn.LayerNorm(motion_channel, eps=1e-5,
                                      elementwise_affine=False)
                         if need_norm_out else nn.Identity())

    def forward(self, video: torch.Tensor,
                mask_ratio: Optional[Union[float, torch.Tensor]] = None, *,
                perm: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        n, t, c, h, w = video.shape
        hidden, ltok = self.hidden, self.motion_token_num
        x = self.patch_embed(video.reshape(n * t, c, h, w)) + self.spos
        x = x.reshape(n, t, x.shape[1], hidden) + self.tpos[None, :t, None, :]
        site_keep = None
        # the sites are masked, shared across time
        if torch.is_tensor(mask_ratio):
            # every site stays (each is its own batch row here); the dropped
            # ones are flagged for the DiT's key mask
            x, site_keep = shuffle_mask_tokens(x, mask_ratio, axis=2,
                                               perm=perm, generator=generator)
        elif mask_ratio is not None:
            x = random_mask_tokens(x, mask_ratio, axis=2, u=u,
                                   generator=generator)
        s = x.shape[2]

        mtok = self.motion_embed(self.motion_token)
        mtok = mtok[:, None].expand(n, s, ltok, hidden)
        if ltok != t:
            if t < ltok or t % ltok:
                raise ValueError(
                    f"camera encoder: frame count {t} must be a multiple of "
                    f"motion_token_num {ltok} (the tokens are stretched to "
                    f"T by repetition)")
            mtok = mtok.repeat_interleave(t // ltok, dim=2)
        mtok = mtok.reshape(n * s, t, hidden) + self.tpos[None, :t]

        kv = x.transpose(1, 2).reshape(n * s, t, hidden)
        for blk in self.transformer_blocks:
            mtok = blk(mtok, kv)
        mtok = self.norm_out(self.proj_out(self.norm_final(mtok)))
        out = mtok.reshape(n, s, t, self.motion_channel).transpose(1, 2)
        return out if site_keep is None else (out, site_keep)


class MotionSequenceTransformer(nn.Module):
    """Motion tokens (N, F, L, D) -> (N, F, L, D): embedded, given 1-D
    positions over the flattened F*L sequence, N self-attention layers,
    projected back to D."""

    def __init__(self, motion_token_num: int = 4,
                 motion_token_channel: int = 128, motion_frames: int = 128,
                 heads: int = 16, head_dim: int = 64, num_layers: int = 8):
        super().__init__()
        hidden = heads * head_dim
        self.hidden, self.motion_token_channel = hidden, motion_token_channel
        self.embed = nn.Linear(motion_token_channel, hidden)
        self.register_buffer(
            "pos", _table(emb_ops.get_1d_sincos_pos_embed(
                hidden, motion_token_num * motion_frames))[None],
            persistent=False)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(hidden, heads, head_dim)
             for _ in range(num_layers)])
        self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
        self.proj_out = nn.Linear(hidden, motion_token_channel)

    def forward(self, motion: torch.Tensor) -> torch.Tensor:
        n, f, l, _ = motion.shape
        x = self.embed(motion).reshape(n, f * l, self.hidden) + \
            self.pos[:, :f * l]
        for blk in self.transformer_blocks:
            x = blk(x)
        x = self.proj_out(self.norm_final(x))
        return x.reshape(n, f, l, self.motion_token_channel)
