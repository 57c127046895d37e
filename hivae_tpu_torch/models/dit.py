"""Velocity DiTs of AMD_N (port of ``VelocityDiTImgSpatialTempMotion``,
``VelocityDiTTempMotion``, the ``_DiTBase`` head and the remat policies of
``hivae_tpu/models/dit.py``), layers unrolled.

``VelocityDiTImgSpatialTempMotion`` (``diffusion_model_type="spatial"``):
each layer runs an object joint block ([10 motion tokens, 256 patches] at
the flagship: full-block kernel), a camera joint block ([256 site tokens,
256 patches]: full-block kernel) and a per-pixel temporal ``DiTBlock``
(S = frames: plain attention). ``VelocityDiTTempMotion`` (``"default"``):
each layer is one object joint block per frame, the image tokens carrying
a temporal position; it has no camera stream.

``remat=True`` is the counterpart of the JAX package's ``nn.remat`` of a
layer: under autograd each layer of the loop runs inside
``torch.utils.checkpoint`` (non-reentrant), and ``remat_policy`` says what
the layer keeps for the backward:

  * ``full``: its inputs only; the rest is recomputed;
  * ``dots``: also the outputs of the matmuls without batch dimensions
    (``aten.mm``/``aten.addmm``, i.e. the dense layers; ``bmm`` is
    recomputed), as XLA's ``dots_with_no_batch_dims_saveable``;
  * ``dots_sans_ffn``: as ``dots``, but a matmul whose output features
    exceed twice its input features (the FFN up-projection, the AdaLN
    projections) is recomputed (``_dots_sans_ffn_policy``'s rule);
  * ``dots_offload``: what ``dots`` keeps, copied to pinned host memory
    (non-blocking copies) in the forward and back to the device in the
    recompute; the rest is recomputed.

The hand-written attention kernels are launched through ctypes, below
PyTorch's dispatcher, so no policy can keep their outputs: they are
recomputed, as the JAX policies never save a ``pallas_call``. Without grad
(serving) the layers run directly.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops import embeddings as emb_ops
from .blocks import (AdaLayerNorm, DiTBlock, JointTransformerBlock, PatchEmbed,
                     TimestepEmbedding)

REMAT_POLICIES = ("full", "dots", "dots_sans_ffn", "dots_offload")

_aten = torch.ops.aten
# matmuls without batch dimensions: what the dense layers dispatch to
_MATMULS = (_aten.mm.default, _aten.addmm.default)


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


# -- remat policies --------------------------------------------------------------


def _saves_dot(func, args) -> bool:
    return func in _MATMULS


def _saves_dot_sans_ffn(func, args) -> bool:
    """A matmul's output is kept unless its output features exceed twice
    its input features: mat2 (K, N) is the last operand of mm and addmm."""
    if func not in _MATMULS:
        return False
    k, n = args[-1].shape
    return n <= 2 * k


def _selective(saves: Callable) -> Callable:
    def policy(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if saves(func, args)
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


class _OffloadSave(TorchDispatchMode):
    """Forward of a ``dots_offload`` layer: each matmul output is copied to
    (pinned, on a card) host memory, in call order."""

    def __init__(self, storage: List[torch.Tensor]):
        super().__init__()
        self.storage = storage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _MATMULS:
            host = torch.empty(out.shape, dtype=out.dtype,
                               pin_memory=out.is_cuda)
            host.copy_(out, non_blocking=True)
            self.storage.append(host)
        return out


class _OffloadLoad(TorchDispatchMode):
    """Recompute of a ``dots_offload`` layer: each matmul takes its output
    back from host memory instead of running; everything else reruns."""

    def __init__(self, storage: List[torch.Tensor]):
        super().__init__()
        self.storage = storage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _MATMULS:
            return self.storage.pop(0).to(args[-1].device, non_blocking=True)
        return func(*args, **(kwargs or {}))


def _offload_contexts():
    storage: List[torch.Tensor] = []
    return _OffloadSave(storage), _OffloadLoad(storage)


_CONTEXT_FNS: Dict[str, Callable] = {
    "dots": _selective(_saves_dot),
    "dots_sans_ffn": _selective(_saves_dot_sans_ffn),
    "dots_offload": _offload_contexts,
}


class _DiTBase(nn.Module):
    """What the velocity DiTs share: the timestep embedding, the image
    patch embedding with its 2-D and temporal positions, the object-motion
    sequence, the checkpointed layer call and the AdaLN head."""

    def __init__(self, heads: int, head_dim: int, out_channels: int,
                 image_height: int, image_width: int, image_patch_size: int,
                 image_in_channels: int, time_embed_dim: int,
                 motion_target_num_frame: int, remat: bool,
                 remat_policy: str):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}; one of "
                             f"{REMAT_POLICIES}")
        self.remat, self.remat_policy = remat, remat_policy
        hidden = heads * head_dim
        self.hidden, self.heads, self.head_dim = hidden, heads, head_dim
        self.time_embed_dim = time_embed_dim
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

    def _blocks(self, cls, num_layers: int) -> nn.ModuleList:
        return nn.ModuleList([cls(self.hidden, self.heads, self.head_dim,
                                  self.time_embed_dim)
                              for _ in range(num_layers)])

    def _object_motion_embed(self, in_channels: int) -> None:
        self.object_motion_patch_embed = nn.Linear(in_channels, self.hidden)
        self.source_token = nn.Parameter(torch.zeros(1, 1, self.hidden))
        self.target_token = nn.Parameter(torch.zeros(1, 1, self.hidden))

    def _build_head(self) -> None:
        hidden = self.hidden
        self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
        self.norm_out = AdaLayerNorm(hidden, self.time_embed_dim)
        self.proj_out = nn.Linear(hidden,
                                  self.patch ** 2 * self.out_channels)

    def _image_tokens(self, image_hidden_states) -> torch.Tensor:
        """(n*T, C, H, W) -> (n*T, S, hidden) with 2-D and frame
        positions."""
        n_t, _, hi, wi = image_hidden_states.shape
        t = self.frames
        s = hi * wi // self.patch ** 2
        img = self.image_patch_embed(image_hidden_states) + self.pos2d
        img = img.reshape(n_t // t, t, s, self.hidden) + \
            self.tpos[:, :, None]
        return img.reshape(n_t, s, self.hidden)

    def _object_motion(self, source, target) -> torch.Tensor:
        """[source token, source, target token, target] + 1-D positions."""
        n_t, hidden = source.shape[0], self.hidden
        msl = 2 * target.shape[1] + 2
        motion = torch.cat(
            [self.source_token.expand(n_t, 1, hidden),
             self.object_motion_patch_embed(source),
             self.target_token.expand(n_t, 1, hidden),
             self.object_motion_patch_embed(target)], dim=1)
        return motion + _pos1d(hidden, msl).to(motion)

    def _run_layer(self, layer, *args):
        """``layer(*args)``, checkpointed under ``remat`` with grad on."""
        if not (self.remat and torch.is_grad_enabled()):
            return layer(*args)
        kw = {}
        if self.remat_policy != "full":
            kw["context_fn"] = _CONTEXT_FNS[self.remat_policy]
        return checkpoint(layer, *args, use_reentrant=False, **kw)

    def _head(self, img_tokens, emb, height, width):
        x = self.norm_out(self.norm_final(img_tokens), emb)
        return unpatchify(self.proj_out(x), height, width, self.patch,
                          self.out_channels)


class VelocityDiTImgSpatialTempMotion(_DiTBase):
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
        super().__init__(heads, head_dim, out_channels, image_height,
                         image_width, image_patch_size, image_in_channels,
                         time_embed_dim, motion_target_num_frame, remat,
                         remat_policy)
        if use_camera:
            self.camera_motion_patch_embed = nn.Linear(
                camera_motion_in_channels, self.hidden)
            self.camera_transformer_blocks = self._blocks(
                JointTransformerBlock, num_layers)
        if use_object:
            self._object_motion_embed(object_motion_in_channels)
            self.object_transformer_blocks = self._blocks(
                JointTransformerBlock, num_layers)
        self.spatial_blocks = self._blocks(DiTBlock, num_layers)
        self._build_head()

    def forward(self, image_hidden_states, timestep,
                camera_motion_target=None, object_motion_source=None,
                object_motion_target=None, camera_site_mask=None):
        n_t, _, hi, wi = image_hidden_states.shape
        n = n_t // self.frames
        s = hi * wi // self.patch ** 2

        emb = self.time_embedding(timestep)
        # per-spatial-site emb: each clip's first-frame emb over its sites
        emb_s = emb.reshape(n, self.frames, -1)[:, 0:1, :].expand(
            n, s, emb.shape[-1])
        emb_s = emb_s.reshape(n * s, -1)
        img = self._image_tokens(image_hidden_states)

        cam = cam_mask = None
        if camera_motion_target is not None:
            nc, tc, sc, dc = camera_motion_target.shape
            cam = self.camera_motion_patch_embed(
                camera_motion_target.reshape(nc * tc, sc, dc))
            if camera_site_mask is not None:  # (n, sc) per clip -> per frame
                cam_mask = camera_site_mask.repeat_interleave(tc, dim=0)

        motion = None
        if object_motion_source is not None:
            motion = self._object_motion(object_motion_source,
                                         object_motion_target)

        for i in range(len(self.spatial_blocks)):
            motion, cam, img = self._run_layer(self._layer, i, motion, cam,
                                               img, emb, emb_s, cam_mask)
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


class VelocityDiTTempMotion(_DiTBase):
    """Per-frame object-motion joint blocks over image tokens that carry a
    temporal position (the ``default`` DiT); batch layout N = n * frames,
    one timestep per frame."""

    def __init__(self, heads: int = 20, head_dim: int = 64,
                 out_channels: int = 4, num_layers: int = 12,
                 image_height: int = 32, image_width: int = 32,
                 image_patch_size: int = 2, image_in_channels: int = 4,
                 time_embed_dim: int = 512,
                 object_motion_in_channels: int = 64,
                 motion_target_num_frame: int = 16, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__(heads, head_dim, out_channels, image_height,
                         image_width, image_patch_size, image_in_channels,
                         time_embed_dim, motion_target_num_frame, remat,
                         remat_policy)
        self._object_motion_embed(object_motion_in_channels)
        self.object_transformer_blocks = self._blocks(JointTransformerBlock,
                                                      num_layers)
        self._build_head()

    def forward(self, image_hidden_states, timestep,
                object_motion_source=None, object_motion_target=None):
        hi, wi = image_hidden_states.shape[-2:]
        emb = self.time_embedding(timestep)
        img = self._image_tokens(image_hidden_states)
        motion = self._object_motion(object_motion_source,
                                     object_motion_target)
        for blk in self.object_transformer_blocks:
            motion, img = self._run_layer(blk, motion, img, emb)
        return self._head(img, emb, hi, wi)
