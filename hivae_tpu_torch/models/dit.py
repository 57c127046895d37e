"""Velocity and reconstruction DiTs (port of
``VelocityDiTImgSpatialTempMotion``, ``VelocityDiTTempMotion``,
``VelocityDiT``, ``VelocityDiTImgSpatial``, ``VelocityDiTDualStream``,
``ReconstructionDiT``, ``ReconstructionDiTSplit``, ``VelocityDiTSplitInput``,
``DiT2Condition``, the ``_DiTBase`` head and the remat policies of
``hivae_tpu/models/dit.py``), layers unrolled.

``VelocityDiTImgSpatialTempMotion`` (``diffusion_model_type="spatial"``):
each layer runs an object joint block ([10 motion tokens, 256 patches] at
the flagship: full-block kernel), a camera joint block ([256 site tokens,
256 patches]: full-block kernel) and a per-pixel temporal ``DiTBlock``
(S = frames: plain attention). ``VelocityDiTTempMotion`` (``"default"``):
each layer is one object joint block per frame, the image tokens carrying
a temporal position; it has no camera stream.

The dual-encoder ``AMDModel``'s decoders: ``VelocityDiT`` (``default``)
runs one joint block a layer over [2L + 2 motion tokens, the patches]
(282 tokens at AMD_S widths: full-block kernel); ``plus`` sums the camera
and object streams, ``decouple`` runs the camera stream through layers
[0, 8) and the object stream through [6, L), as the reference does.
``VelocityDiTImgSpatial`` (``spatial``) adds a per-pixel temporal
``DiTBlock`` (S = frames: plain attention) after each joint block.
``VelocityDiTDualStream`` (``dual``) runs a ``MotionTemporalBlock`` over a
clip's T * (2L + 2) motion tokens (416 at AMD_S widths: full-block kernel)
before each joint block. ``ReconstructionDiT`` and
``ReconstructionDiTSplit`` (``AMDModelRec``) take no timestep: plain
self-attention blocks over the image and motion tokens (538 in the split
form at AMD_S widths). ``VelocityDiTSplitInput`` and ``DiT2Condition``,
which no model of the repository builds, attend jointly over grid motion
tokens and image patches (at 32^2 latents with patch 2: 512 patches of zi
and zt, or 256 + 256 + the motion grid: the full-block kernel); they take
no ``remat``.

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
from .blocks import (AdaLayerNorm, BasicTransformerBlock, DiTBlock,
                     JointBlock2Condition, JointTransformerBlock,
                     MotionTemporalBlock, PatchEmbed, TimestepEmbedding)

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


def check_token_counts(camera_tokens: int, object_tokens: int) -> None:
    """The dual-encoder DiTs give the camera and the object tokens the same
    positions, so the two counts must be equal (the JAX package fails there
    on a broadcast)."""
    if camera_tokens != object_tokens:
        raise ValueError(
            f"the camera stream has {camera_tokens} motion tokens and the "
            f"object stream {object_tokens}: the dual-encoder AMDModel's DiT "
            f"takes its positions from the camera tokens and adds them to "
            f"the object tokens, so set camera_motion_token_num equal to "
            f"object_motion_token_num")


class _MotionTokenDiT(_DiTBase):
    """A DiT whose motion streams share one embedding and the reference's
    [source token, source, target token, target] layout, with the position
    table of that layout; the image tokens carry the 2-D positions only
    unless a subclass adds frame positions."""

    def __init__(self, heads, head_dim, out_channels, image_height,
                 image_width, image_patch_size, image_in_channels,
                 motion_in_channels, time_embed_dim, motion_target_num_frame,
                 remat, remat_policy, token_init: str = "zeros"):
        super().__init__(heads, head_dim, out_channels, image_height,
                         image_width, image_patch_size, image_in_channels,
                         time_embed_dim, motion_target_num_frame, remat,
                         remat_policy)
        self.motion_patch_embed = nn.Linear(motion_in_channels, self.hidden)
        init = torch.zeros if token_init == "zeros" else \
            (lambda *shape: 0.02 * torch.randn(*shape))
        self.source_token = nn.Parameter(init(1, 1, self.hidden))
        self.target_token = nn.Parameter(init(1, 1, self.hidden))

    def _tokens(self, n: int):
        """(source token, target token), each (n, 1, hidden)."""
        return (self.source_token.expand(n, 1, self.hidden),
                self.target_token.expand(n, 1, self.hidden))

    def _mpos(self, length: int, like: torch.Tensor) -> torch.Tensor:
        return _pos1d(self.hidden, length).to(like)

    def _pair(self, source, target) -> torch.Tensor:
        """[source token, source, target token, target] + 1-D positions."""
        s_tok, t_tok = self._tokens(source.shape[0])
        motion = torch.cat([s_tok, self.motion_patch_embed(source), t_tok,
                            self.motion_patch_embed(target)], dim=1)
        return motion + self._mpos(motion.shape[1], motion)

    def _decoupled(self, run, img, camera_target, camera_source,
                   object_source, camera_until: int, object_from: int,
                   num_layers: int) -> torch.Tensor:
        """``decouple``: the camera stream ([source token, source, target
        token, target], or [target token, target] without a source) through
        layers [0, ``camera_until``), then, with an object stream, the
        object stream through [``object_from``, L) with the camera pass's
        special tokens; ``run(layers, motion, img)`` runs layers. The object
        target is built from the object source, as the reference builds it
        (kept for the behaviour of its checkpoints). Returns the image
        tokens."""
        l = camera_target.shape[1]
        msl = 2 * l + 2
        mpos = self._mpos(msl, img)
        s_tok, t_tok = self._tokens(img.shape[0])
        cam_tgt = self.motion_patch_embed(camera_target)
        if camera_source is not None:
            cam = torch.cat([s_tok, self.motion_patch_embed(camera_source),
                             t_tok, cam_tgt], dim=1) + mpos
        else:
            cam = torch.cat([t_tok, cam_tgt], dim=1) + mpos[:, :l + 1]
        if object_source is None:
            return run(range(num_layers), cam, img)[1]
        obj_src = self.motion_patch_embed(object_source) + mpos[:, 1:l + 1]
        obj_tgt = obj_src + mpos[:, l + 2:msl]
        motion, img = run(range(min(camera_until, num_layers)), cam, img)
        if camera_source is not None:
            s_tok, t_tok = motion[:, 0:1], motion[:, l + 1:l + 2]
        else:
            t_tok = motion[:, 0:1]
        motion = torch.cat([s_tok, obj_src, t_tok, obj_tgt], dim=1)
        return run(range(min(object_from, num_layers), num_layers), motion,
                   img)[1]


def sum_streams(a, b):
    """The camera and object streams summed; either may be None (the
    refimg-motion path carries its tokens in one stream)."""
    if a is None or b is None:
        return b if a is None else a
    check_token_counts(a.shape[1], b.shape[1])
    return a + b


class VelocityDiT(_MotionTokenDiT):
    """One joint block a layer over the motion and image tokens (the
    dual-encoder ``default`` DiT). ``plus`` sums the camera and object
    streams (either may ride alone); ``decouple`` runs the camera stream
    through layers [0, ``camera_layers``) and the object stream, which
    takes the camera pass's special tokens, through [``object_from``, L):
    the reference's layer ranges, which overlap."""

    def __init__(self, heads: int = 20, head_dim: int = 64,
                 out_channels: int = 4, num_layers: int = 12,
                 image_height: int = 32, image_width: int = 32,
                 image_patch_size: int = 2, image_in_channels: int = 4,
                 motion_in_channels: int = 128, time_embed_dim: int = 512,
                 motion_type: str = "decouple", camera_layers: int = 8,
                 object_from: int = 6, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__(heads, head_dim, out_channels, image_height,
                         image_width, image_patch_size, image_in_channels,
                         motion_in_channels, time_embed_dim, 1, remat,
                         remat_policy)
        self.motion_type = motion_type
        self.camera_layers, self.object_from = camera_layers, object_from
        self.transformer_blocks = self._blocks(JointTransformerBlock,
                                               num_layers)
        self._build_head()

    def forward(self, camera_motion_target, image_hidden_states, timestep,
                camera_motion_source=None, object_motion_source=None,
                object_motion_target=None):
        hi, wi = image_hidden_states.shape[-2:]
        l = camera_motion_target.shape[1]
        if object_motion_source is not None:
            check_token_counts(l, object_motion_source.shape[1])
        emb = self.time_embedding(timestep)
        img = self.image_patch_embed(image_hidden_states) + self.pos2d
        blocks = self.transformer_blocks

        def run(layers, motion, img):
            for i in layers:
                motion, img = self._run_layer(blocks[i], motion, img, emb)
            return motion, img

        if self.motion_type == "plus":
            motion = self._pair(sum_streams(camera_motion_source,
                                            object_motion_source),
                                sum_streams(camera_motion_target,
                                            object_motion_target))
            img = run(range(len(blocks)), motion, img)[1]
        else:
            img = self._decoupled(run, img, camera_motion_target,
                                  camera_motion_source, object_motion_source,
                                  self.camera_layers, self.object_from,
                                  len(blocks))
        return self._head(img, emb, hi, wi)


class VelocityDiTImgSpatial(_MotionTokenDiT):
    """A joint block and a per-pixel temporal ``DiTBlock`` a layer, the
    image tokens carrying frame positions (the dual-encoder ``spatial``
    DiT). ``plus`` feeds the object tokens only, as the reference does;
    ``decouple`` runs the camera stream through layers [0,
    ``camera_until``) and the object stream through [``object_from``,
    L)."""

    def __init__(self, heads: int = 20, head_dim: int = 64,
                 out_channels: int = 4, num_layers: int = 12,
                 image_height: int = 32, image_width: int = 32,
                 image_patch_size: int = 2, image_in_channels: int = 4,
                 motion_in_channels: int = 128, time_embed_dim: int = 512,
                 motion_type: str = "plus", motion_target_num_frame: int = 16,
                 camera_until: int = 6, object_from: int = 6,
                 remat: bool = False, remat_policy: str = "full"):
        super().__init__(heads, head_dim, out_channels, image_height,
                         image_width, image_patch_size, image_in_channels,
                         motion_in_channels, time_embed_dim,
                         motion_target_num_frame, remat, remat_policy)
        self.motion_type = motion_type
        self.camera_until, self.object_from = camera_until, object_from
        self.transformer_blocks = self._blocks(JointTransformerBlock,
                                               num_layers)
        self.spatial_blocks = self._blocks(DiTBlock, num_layers)
        self._build_head()

    def _layer(self, i, motion, img, emb, emb_s):
        """Layer i: the joint block, then the per-pixel temporal block."""
        n_t, s, hidden = img.shape
        t = self.frames
        n = n_t // t
        motion, img = self.transformer_blocks[i](motion, img, emb)
        img = img.reshape(n, t, s, hidden).transpose(1, 2).reshape(
            n * s, t, hidden)
        img = self.spatial_blocks[i](img, emb_s)
        img = img.reshape(n, s, t, hidden).transpose(1, 2).reshape(
            n_t, s, hidden)
        return motion, img

    def forward(self, camera_motion_target, image_hidden_states, timestep,
                camera_motion_source=None, object_motion_source=None,
                object_motion_target=None):
        n_t, _, hi, wi = image_hidden_states.shape
        n = n_t // self.frames
        s = hi * wi // self.patch ** 2
        l = camera_motion_target.shape[1]
        if object_motion_source is not None:
            check_token_counts(l, object_motion_source.shape[1])
        num_layers = len(self.spatial_blocks)
        emb = self.time_embedding(timestep)
        emb_s = emb.reshape(n, self.frames, -1)[:, 0:1, :].expand(
            n, s, emb.shape[-1]).reshape(n * s, -1)
        img = self._image_tokens(image_hidden_states)

        def run(layers, motion, img):
            for i in layers:
                motion, img = self._run_layer(self._layer, i, motion, img,
                                              emb, emb_s)
            return motion, img

        if self.motion_type == "plus":
            # the reference feeds the object tokens only here
            motion = self._pair(object_motion_source, object_motion_target)
            img = run(range(num_layers), motion, img)[1]
        else:
            img = self._decoupled(run, img, camera_motion_target,
                                  camera_motion_source, object_motion_source,
                                  self.camera_until, self.object_from,
                                  num_layers)
        return self._head(img, emb, hi, wi)


class VelocityDiTDualStream(_MotionTokenDiT):
    """A ``MotionTemporalBlock`` over each clip's T * (2L + 2) motion
    tokens (AdaLN on the clip's first-frame timestep embedding), then a
    joint block over each frame's motion and image tokens, a layer (the
    dual-encoder ``dual`` DiT). Its special tokens start from N(0, 0.02)."""

    def __init__(self, heads: int = 20, head_dim: int = 64,
                 out_channels: int = 4, num_layers: int = 12,
                 image_height: int = 32, image_width: int = 32,
                 image_patch_size: int = 2, image_in_channels: int = 4,
                 motion_in_channels: int = 128, time_embed_dim: int = 512,
                 motion_target_num_frame: int = 16, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__(heads, head_dim, out_channels, image_height,
                         image_width, image_patch_size, image_in_channels,
                         motion_in_channels, time_embed_dim,
                         motion_target_num_frame, remat, remat_policy,
                         token_init="normal")
        self.motion_blocks = nn.ModuleList(
            [MotionTemporalBlock(self.hidden, heads, head_dim,
                                 use_adaln=True, cond_dim=time_embed_dim)
             for _ in range(num_layers)])
        self.transformer_blocks = self._blocks(JointTransformerBlock,
                                               num_layers)
        self._build_head()

    def _layer(self, i, motion, img, emb, emb_m):
        n_t, hidden = img.shape[0], self.hidden
        n = n_t // self.frames
        motion = self.motion_blocks[i](motion, emb_m)
        motion, img = self.transformer_blocks[i](
            motion.reshape(n_t, -1, hidden), img, emb)
        return motion.reshape(n, -1, hidden), img

    def forward(self, motion_source, motion_target, image_hidden_states,
                timestep):
        n_t, _, hi, wi = image_hidden_states.shape
        t = self.frames
        n = n_t // t
        emb = self.time_embedding(timestep)
        emb_m = emb.reshape(n, t, -1)[:, 0]
        img = self.image_patch_embed(image_hidden_states) + self.pos2d
        motion = self._pair(motion_source, motion_target)
        motion = motion.reshape(n, -1, self.hidden)
        motion = motion + self._mpos(motion.shape[1], motion)
        for i in range(len(self.transformer_blocks)):
            motion, img = self._run_layer(self._layer, i, motion, img, emb,
                                          emb_m)
        return self._head(img, emb, hi, wi)


class ReconstructionDiT(nn.Module):
    """Timestep-free reconstruction transformer of ``AMDModelRec``:
    self-attention blocks over [image patches, source token, source motion,
    target token, target motion], a LayerNorm and a projection of the
    image tokens. ``split`` embeds zi and zt with patch embeddings of their
    own (``ReconstructionDiTSplit``): [zt patches, zi patches, motion]."""

    def __init__(self, heads: int = 20, head_dim: int = 64,
                 out_channels: int = 4, num_layers: int = 12,
                 image_height: int = 32, image_width: int = 32,
                 image_patch_size: int = 2, image_in_channels: int = 4,
                 motion_in_channels: int = 128, split: bool = False):
        super().__init__()
        hidden = heads * head_dim
        self.hidden, self.split = hidden, split
        self.patch, self.out_channels = image_patch_size, out_channels
        self.motion_patch_embed = nn.Linear(motion_in_channels, hidden)
        if split:
            self.zi_image_patch_embed = PatchEmbed(
                image_patch_size, image_in_channels // 2, hidden)
            self.zt_image_patch_embed = PatchEmbed(
                image_patch_size, image_in_channels // 2, hidden)
        else:
            self.image_patch_embed = PatchEmbed(image_patch_size,
                                                image_in_channels, hidden)
        self.register_buffer("pos2d", _pos2d(hidden, image_height,
                                             image_width, image_patch_size),
                             persistent=False)
        self.source_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.target_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(hidden, heads, head_dim)
             for _ in range(num_layers)])
        self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
        self.proj_out = nn.Linear(hidden, image_patch_size ** 2 * out_channels)

    def forward(self, motion_source, motion_target, image_hidden_states):
        n, ci, hi, wi = image_hidden_states.shape
        hidden = self.hidden
        motion = torch.cat(
            [self.source_token.expand(n, 1, hidden),
             self.motion_patch_embed(motion_source),
             self.target_token.expand(n, 1, hidden),
             self.motion_patch_embed(motion_target)], dim=1)
        motion = motion + _pos1d(hidden, motion.shape[1]).to(motion)
        if self.split:
            zi = self.zi_image_patch_embed(image_hidden_states[:, :ci // 2])
            zt = self.zt_image_patch_embed(image_hidden_states[:, ci // 2:])
            img = [zt + self.pos2d, zi + self.pos2d]
        else:
            img = [self.image_patch_embed(image_hidden_states) + self.pos2d]
        isl = img[0].shape[1]
        x = torch.cat(img + [motion], dim=1)
        for blk in self.transformer_blocks:
            x = blk(x)
        x = self.proj_out(self.norm_final(x[:, :isl]))
        return unpatchify(x, hi, wi, self.patch, self.out_channels)


def _pos3d(hidden: int, grid: tuple, frames: int, length: int
           ) -> torch.Tensor:
    """The first ``length`` rows of the 3-D sincos table over ``grid``
    ((w, h), diffusers' order) and ``frames`` frames, (1, length,
    hidden)."""
    table = emb_ops.get_3d_sincos_pos_embed(hidden, tuple(grid), frames)
    return torch.from_numpy(table.reshape(1, -1, hidden)[:, :length].copy())


class _GridDiT(nn.Module):
    """The timestep embedding and AdaLN head of the grid-input DiTs."""

    def __init__(self, heads: int, head_dim: int, out_channels: int,
                 image_patch_size: int, time_embed_dim: int):
        super().__init__()
        self.hidden = hidden = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.time_embed_dim = time_embed_dim
        self.out_channels, self.patch = out_channels, image_patch_size
        self.time_embedding = TimestepEmbedding(hidden, time_embed_dim)
        _DiTBase._build_head(self)

    def _block_list(self, cls, num_layers: int) -> nn.ModuleList:
        return nn.ModuleList([cls(self.hidden, self.heads, self.head_dim,
                                  self.time_embed_dim)
                              for _ in range(num_layers)])

    _head = _DiTBase._head


class VelocityDiTSplitInput(_GridDiT):
    """Split zi/zt patch embeddings, grid motion tokens and 3-D positions
    (the reference's ``AMDDiffusionTransformerModelSplitInput``): each
    layer a joint block over [motion grid tokens, zi patches, zt patches];
    the head reads the zt patches. The image positions are the first
    2 * patches rows of a 2-frame 3-D table over the (w, h) patch grid.
    ``image_hidden_states`` is (N, 2C, H, W): zi, then zt."""

    def __init__(self, heads: int = 20, head_dim: int = 64,
                 out_channels: int = 4, num_layers: int = 12,
                 image_patch_size: int = 2, image_in_channels: int = 4,
                 motion_in_channels: int = 128, motion_patch_size: int = 1,
                 time_embed_dim: int = 512):
        super().__init__(heads, head_dim, out_channels, image_patch_size,
                         time_embed_dim)
        hidden = self.hidden
        self.motion_patch_embed = PatchEmbed(motion_patch_size,
                                             motion_in_channels, hidden)
        self.zi_patch_embed = PatchEmbed(image_patch_size, image_in_channels,
                                         hidden)
        self.zt_patch_embed = PatchEmbed(image_patch_size, image_in_channels,
                                         hidden)
        self.transformer_blocks = self._block_list(JointTransformerBlock,
                                                   num_layers)

    def forward(self, motion_hidden_states, image_hidden_states, timestep):
        ci, hi, wi = image_hidden_states.shape[1:]
        p = self.patch
        isl = 2 * (hi // p) * (wi // p)
        emb = self.time_embedding(timestep)
        motion = self.motion_patch_embed(motion_hidden_states)
        img = torch.cat(
            [self.zi_patch_embed(image_hidden_states[:, :ci // 2]),
             self.zt_patch_embed(image_hidden_states[:, ci // 2:])], dim=1)
        img = img + _pos3d(self.hidden, (wi // p, hi // p), 2, isl).to(img)
        for block in self.transformer_blocks:
            motion, img = block(motion, img, emb)
        return self._head(img[:, isl // 2:], emb, hi, wi)


class DiT2Condition(_GridDiT):
    """Three-stream DiT over the image, the reference image and grid motion
    (the reference's ``DiffusionTransformerModel2Condition``): each layer a
    ``JointBlock2Condition``; the head reads the image stream. As the JAX
    package builds it, the image table is a 2-frame 3-D table over
    (iph, iph) patches, whatever the width (the image takes its first
    iph * ipw rows, the reference image the next as many), and the motion
    table one of ``motion_frames`` frames over (mph, mph)."""

    def __init__(self, heads: int = 20, head_dim: int = 64,
                 out_channels: int = 4, num_layers: int = 12,
                 image_patch_size: int = 2, image_in_channels: int = 4,
                 motion_in_channels: int = 128, motion_patch_size: int = 1,
                 motion_frames: int = 15, time_embed_dim: int = 512):
        super().__init__(heads, head_dim, out_channels, image_patch_size,
                         time_embed_dim)
        hidden = self.hidden
        self.motion_frames = motion_frames
        self.motion_patch = motion_patch_size
        self.image_patch_embed = PatchEmbed(image_patch_size,
                                            image_in_channels, hidden)
        self.refimg_patch_embed = PatchEmbed(image_patch_size,
                                             image_in_channels, hidden)
        self.motion_patch_embed = PatchEmbed(motion_patch_size,
                                             motion_in_channels, hidden)
        self.transformer_blocks = self._block_list(JointBlock2Condition,
                                                   num_layers)

    def forward(self, hidden_states, refimg_hidden_states,
                motion_hidden_states, timestep):
        hi, wi = hidden_states.shape[2:]
        hm, wm = motion_hidden_states.shape[2:]
        p, mp = self.patch, self.motion_patch
        iph = hi // p
        isl = iph * (wi // p)
        mph = hm // mp
        msl = mph * (wm // mp)
        emb = self.time_embedding(timestep)
        x = self.image_patch_embed(hidden_states)
        ref = self.refimg_patch_embed(refimg_hidden_states)
        motion = self.motion_patch_embed(motion_hidden_states)
        img_pos = _pos3d(self.hidden, (iph, iph), 2, 2 * isl).to(x)
        x = x + img_pos[:, :isl]
        ref = ref + img_pos[:, isl:2 * isl]
        motion = motion + _pos3d(self.hidden, (mph, mph), self.motion_frames,
                                 msl).to(motion)
        for block in self.transformer_blocks:
            x, ref, motion = block(x, ref, motion, emb)
        return self._head(x, emb, hi, wi)
