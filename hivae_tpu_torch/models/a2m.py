"""The audio-to-motion heads (port of ``hivae_tpu/models/a2m.py``).

The heads predict the AMD model's object-motion tokens (N, F, L, D) of an
F-frame window from per-frame audio features (whisper embeddings, (N, F,
M, C)), conditioned on the reference frame's tokens; a rectified-flow walk
(``sample``) draws the tokens through the head's ``conditions`` and
``velocity``:

  * ``A2MModelCrossAttnAudio`` (``variant`` "audio", "pose" or
    "audio_pose"): per layer a joint self-attention block over [reference;
    motion] and a per-frame cross-attention block over each frame's
    condition window (``A2MTransformerCrossAttnAudio``);
  * ``A2MModelPosePre``: the same denoiser with audio and a pose condition
    *predicted* by ``A2PTransformer`` from one reference pose latent, plus
    the pose MSE in training; ``predict_pose`` alone serves ``cli.vis``;
  * ``A2MModelLearnableToken`` (and its ``simple_adaln`` form): joint
    three-stream blocks over motion, reference motion and per-frame MLP
    audio features (``A2MJointTransformer``);
  * ``A2MModelMlp``, the grid head: (N, F, C, h, w) motion grids, the
    reference image and pose latents and the audio features through the
    three-stream ``Audio2MotionGridDiT``; ``sample_grid`` samples it.

The heads' own attentions stay at or under 256^2 logits (the cross heads'
1 + F frames of L tokens and L queries against a window of W keys,
LearnableToken's L (F + 1) + F tokens, the pose predictor's F + 1 frames,
its patch tokens and their audio windows), so ``ops.attention.sdpa`` sends
them to its plain path, as the JAX package sends them to XLA. The grid
head's joint block (16 frames of a 4 x 4 grid, 256 image patches and 16
audio tokens: 528) is above it and runs the full-block kernel.

The 1-D sincos table of the motion positions holds ``motion_num_token *
(motion_frames + 1)`` rows; a call with more tokens a window, L * (F + 1),
is refused with a ``ValueError`` naming both counts, where the JAX package
fails on a broadcast. ``motion_num_token`` sizes only that table, so a
head pairs with an AMD model whose ``object_motion_token_num`` is L when
``motion_num_token`` is at least L. A head that conditions on pose
refuses a ``conditions`` call without it (``ValueError`` naming the
input), where the JAX package fails on a None.

The training forwards' timestep and flow noise can be injected; what is
not is drawn from the caller's generator in the JAX package's order
(timestep, then noise). ``sample`` and ``sample_grid`` draw their start
noise through ``models.amd.SampleDraws``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from ..ops import quant as quant_ops
from ..ops import rectified_flow as rf
from ..utils.device import resolve_device
from .amd import DrawSource, sample_draws
from ..ops import embeddings as emb_ops
from .blocks import (A2MCrossAttnBlock, A2MMotionSelfAttnBlock,
                     A2PCrossAudioBlock, A2PTemporalSpatialBlock, AdaLayerNorm,
                     AudioFeatureMlp, AudioFeatureWindowMlp,
                     JointBlock2Condition, JointBlock2ConditionSimple,
                     PatchEmbed, TimestepEmbedding)
from .dit import _pos1d, _pos2d, unpatchify

Device = Optional[Union[str, torch.device]]
VARIANTS = ("audio", "audio_pose", "pose")


def _check_tokens(head, tokens: int, frames: int) -> None:
    """Refuse L tokens a frame over F frames and the reference where the
    head's motion position table (``head.pos``) is shorter than
    L * (F + 1)."""
    rows = head.pos.shape[1]
    if tokens * (frames + 1) > rows:
        raise ValueError(
            f"A2M head: {tokens} motion tokens a frame over {frames} "
            f"frames and the reference need {tokens * (frames + 1)} "
            f"positions; its table holds motion_num_token "
            f"{head.motion_num_token} x (motion_frames "
            f"{head.motion_frames} + 1) = {rows}. Set motion_num_token "
            f"to the AMD model's object_motion_token_num ({tokens})")


def _masked_mse(pred, target, mask) -> torch.Tensor:
    """The per-frame MSE of (N, F, ...) tensors, weighted by ``mask`` (N,
    F): sum(mse * mask) / sum(mask), in fp32."""
    diff = (pred.float() - target.float()).square().mean(
        dim=tuple(range(2, pred.dim())))
    return (diff * mask).sum() / mask.sum()


def _flow_draws(cfg, shape, dtype, device, timestep, z0, generator):
    """The training forward's timestep (N,) integer steps in [0, num_step]
    and flow noise of ``shape``, each drawn from ``generator`` (in that
    order) where not given."""
    if timestep is None:
        timestep = torch.randint(0, cfg.num_step + 1, (shape[0],),
                                 generator=generator, device=device)
    if z0 is None:
        z0 = torch.randn(shape, generator=generator, dtype=dtype,
                         device=device)
    return timestep, z0


class A2MTransformerCrossAttnAudio(nn.Module):
    """Motion denoiser: per layer a joint [ref; motion] self-attention
    block, then a per-frame cross-attention block over the audio windows
    (``use_audio``) and one over the pose tokens (``use_pose``)."""

    def __init__(self, motion_num_token: int = 12,
                 motion_inchannel: int = 128, motion_frames: int = 128,
                 audio_in_channels: int = 128, out_channels: int = 128,
                 heads: int = 8, head_dim: int = 64, num_layers: int = 16,
                 time_embed_dim: int = 512, use_pose: bool = False,
                 pose_inchannel: int = 4, pose_patch_size: int = 2,
                 pose_height: int = 32, pose_width: int = 32,
                 use_audio: bool = True):
        super().__init__()
        hidden = heads * head_dim
        self.hidden, self.use_audio, self.use_pose = hidden, use_audio, \
            use_pose
        self.motion_num_token, self.motion_frames = motion_num_token, \
            motion_frames
        self.time_embedding = TimestepEmbedding(hidden, time_embed_dim)
        self.motion_patch_embed = nn.Linear(motion_inchannel, hidden)
        self.refmotion_patch_embed = nn.Linear(motion_inchannel, hidden)
        self.register_buffer(
            "pos", _pos1d(hidden, motion_num_token * (motion_frames + 1)),
            persistent=False)
        block_kw = dict(dim=hidden, heads=heads, head_dim=head_dim,
                        cond_dim=time_embed_dim)
        self.motion_blocks = nn.ModuleList(
            [A2MMotionSelfAttnBlock(**block_kw) for _ in range(num_layers)])
        if use_audio:
            self.audio_embed = nn.Linear(audio_in_channels, hidden)
            self.audio_blocks = nn.ModuleList(
                [A2MCrossAttnBlock(**block_kw) for _ in range(num_layers)])
        if use_pose:
            self.pose_embed = PatchEmbed(pose_patch_size, pose_inchannel,
                                         hidden)
            self.register_buffer(
                "pose_pos", _pos2d(hidden, pose_height, pose_width,
                                   pose_patch_size), persistent=False)
            self.pose_blocks = nn.ModuleList(
                [A2MCrossAttnBlock(**block_kw) for _ in range(num_layers)])
        self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
        self.norm_out = AdaLayerNorm(hidden, time_embed_dim)
        self.proj_out = nn.Linear(hidden, out_channels)

    def check_tokens(self, tokens: int, frames: int) -> None:
        _check_tokens(self, tokens, frames)

    def forward(self, motion, ref_motion, audio=None, pose=None,
                timestep=None):
        """motion (N, F, L, D), ref_motion (N, L, D), audio (N, F+1, W, Da),
        pose (N, F+1, C, h, w) -> velocity (N, F, L, out_channels)."""
        n, f, l, d = motion.shape
        self.check_tokens(l, f)
        dtype = self.proj_out.weight.dtype
        emb = self.time_embedding(timestep)
        motion = self.motion_patch_embed(motion.reshape(n, f * l, d).to(dtype))
        ref = self.refmotion_patch_embed(ref_motion.to(dtype))
        ref = ref + self.pos[:, :l]
        motion = motion + self.pos[:, l:l + f * l]
        if self.use_audio:
            audio = self.audio_embed(audio.to(dtype))
        if self.use_pose:
            tok = self.pose_embed(pose.reshape((-1,) + pose.shape[2:]))
            pose_tok = (tok + self.pose_pos).reshape(n, -1, tok.shape[1],
                                                     self.hidden)
        for i, block in enumerate(self.motion_blocks):
            motion, ref = block(motion, ref, emb)
            if self.use_audio:
                motion, ref = self.audio_blocks[i](motion, ref, audio, emb)
            if self.use_pose:
                motion, ref = self.pose_blocks[i](motion, ref, pose_tok, emb)
        motion = self.norm_out(self.norm_final(motion), emb)
        return self.proj_out(motion).reshape(n, f, l, -1)


@dataclasses.dataclass(frozen=True)
class A2MConfig:
    """Mirror of the JAX package's ``A2MConfig`` (same fields, defaults and
    dict schema, so its yaml and json specs load unchanged)."""

    audio_inchannel: int = 384
    audio_block: int = 50
    motion_num_token: int = 12
    motion_in_channel: int = 128
    motion_frames: int = 128
    num_step: int = 1000
    # audio feature encoder
    intermediate_dim: int = 1024
    window_size: int = 32
    encoder_out_dim: int = 768
    # pose
    pose_height: int = 32
    pose_width: int = 32
    pose_inchannel: int = 4
    pose_patch_size: int = 2
    # diffusion transformer
    diffusion_attn_head_dim: int = 64
    diffusion_attn_num_heads: int = 16
    diffusion_num_layers: int = 8
    # audio->pose predictor head (PosePre variant)
    pose_predictor_attn_head_dim: int = 64
    pose_predictor_attn_num_heads: int = 8
    pose_predictor_attn_num_layers: int = 4
    # grid-motion legacy variant (A2MModelMlp)
    motion_height: int = 4
    motion_width: int = 4
    motion_patch_size: int = 1
    image_inchannel: int = 4
    image_height: int = 32
    image_width: int = 32
    image_patch_size: int = 2
    time_embed_dim: int = 512

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "A2MConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _need(head: str, **inputs) -> None:
    """Refuse a conditions call without the pose inputs the head reads
    (the JAX package fails on them deeper in, on a None)."""
    missing = [k for k, v in inputs.items() if v is None]
    if missing:
        raise ValueError(
            f"{head} conditions on {' and '.join(inputs)}; "
            f"missing: {', '.join(missing)} (a pipeline that passes only "
            f"audio and ref_audio cannot serve it)")


def _velocity_loss(model, motion_gt, ref_motion, cond, mask, timestep, z0,
                   generator) -> torch.Tensor:
    """The per-frame mask-weighted velocity MSE of the motion tokens
    (N, F, L, D) through ``model.velocity`` (``mask`` (N, F), default all
    ones)."""
    c = model.cfg
    timestep, z0 = _flow_draws(c, motion_gt.shape, motion_gt.dtype,
                               motion_gt.device, timestep, z0, generator)
    zt, vel_gt = rf.get_train_tuple(motion_gt, timestep, z0,
                                    num_steps=c.num_step)
    vel_pred = model.velocity(zt, ref_motion, timestep.float(), **cond)
    if mask is None:
        mask = torch.ones(motion_gt.shape[:2], device=motion_gt.device)
    return _masked_mse(vel_pred, vel_gt, mask)


def _cross_denoiser(c: A2MConfig, use_audio: bool, use_pose: bool
                    ) -> A2MTransformerCrossAttnAudio:
    return A2MTransformerCrossAttnAudio(
        motion_num_token=c.motion_num_token,
        motion_inchannel=c.motion_in_channel, motion_frames=c.motion_frames,
        audio_in_channels=c.encoder_out_dim, out_channels=c.motion_in_channel,
        heads=c.diffusion_attn_num_heads, head_dim=c.diffusion_attn_head_dim,
        num_layers=c.diffusion_num_layers, use_pose=use_pose,
        pose_inchannel=c.pose_inchannel, pose_patch_size=c.pose_patch_size,
        pose_height=c.pose_height, pose_width=c.pose_width,
        use_audio=use_audio)


class A2MModelCrossAttnAudio(nn.Module):
    """Audio (and/or pose) to motion-token diffusion head; ``variant``
    "audio", "audio_pose" or "pose" picks the conditioning blocks. The
    denoiser's timestep MLP is 512 wide whatever ``cfg.time_embed_dim``
    says (that field sizes the grid head only), as in the JAX package."""

    def __init__(self, cfg: A2MConfig, variant: str = "audio",
                 device: Device = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
        self.cfg = c = cfg
        self.variant = variant
        self.use_audio = variant in ("audio", "audio_pose")
        self.use_pose = variant in ("pose", "audio_pose")
        dev = resolve_device(device)
        with torch.device(dev):
            if self.use_audio:
                self.audio_encoder = AudioFeatureWindowMlp(
                    c.audio_block * c.audio_inchannel, c.intermediate_dim,
                    c.window_size, c.encoder_out_dim)
            self.diffusion = _cross_denoiser(c, self.use_audio,
                                             self.use_pose)
        # position tables are built on the host; move them with the weights
        self.to(device=dev, dtype=dtype)

    def conditions(self, audio=None, ref_audio=None, pose=None,
                   ref_pose=None) -> Dict[str, torch.Tensor]:
        """The per-frame conditions of a window, the reference frame first:
        ``audio`` the encoded windows of cat(ref_audio, audio) (N, F+1, W,
        D), ``pose`` cat(ref_pose, pose) (N, F+1, C, h, w)."""
        cond = {}
        if self.use_audio:
            cond["audio"] = self.audio_encoder(
                torch.cat([ref_audio[:, None], audio], dim=1))
        if self.use_pose:
            _need(f"A2MModelCrossAttnAudio ({self.variant})", pose=pose,
                  ref_pose=ref_pose)
            cond["pose"] = torch.cat([ref_pose[:, None], pose], dim=1)
        return cond

    def velocity(self, zt, ref_motion, timestep, **cond) -> torch.Tensor:
        return self.diffusion(zt, ref_motion, timestep=timestep, **cond)

    def forward(self, motion_gt, ref_motion, audio=None, ref_audio=None,
                pose=None, ref_pose=None, mask=None,
                timestep: Optional[torch.Tensor] = None,
                z0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The per-frame mask-weighted velocity MSE of ``motion_gt`` (N, F,
        L, D) with ``ref_motion`` (N, L, D); ``mask`` (N, F) weights the
        frames (default all ones). ``timestep`` (N,) integer steps in [0,
        num_step] and ``z0`` the flow noise are drawn from ``generator``
        (in that order) where not given. Returns {loss, diff_loss}."""
        cond = self.conditions(audio, ref_audio, pose, ref_pose)
        loss = _velocity_loss(self, motion_gt, ref_motion, cond, mask,
                              timestep, z0, generator)
        return {"loss": loss, "diff_loss": loss}


class A2MJointTransformer(nn.Module):
    """Motion denoiser of the LearnableToken heads: joint three-stream
    blocks over (motion, reference motion, per-frame audio features);
    ``simple_adaln`` picks ``JointBlock2ConditionSimple`` (AdaLN on the
    motion stream only) over ``JointBlock2Condition``."""

    def __init__(self, motion_num_token: int = 12,
                 motion_inchannel: int = 128, motion_frames: int = 128,
                 extra_in_channels: int = 768, out_channels: int = 128,
                 heads: int = 8, head_dim: int = 64, num_layers: int = 16,
                 time_embed_dim: int = 512, simple_adaln: bool = False):
        super().__init__()
        hidden = heads * head_dim
        self.motion_num_token, self.motion_frames = motion_num_token, \
            motion_frames
        self.time_embedding = TimestepEmbedding(hidden, time_embed_dim)
        self.motion_patch_embed = nn.Linear(motion_inchannel, hidden)
        self.refmotion_patch_embed = nn.Linear(motion_inchannel, hidden)
        self.extra_embed = nn.Linear(extra_in_channels, hidden)
        self.register_buffer(
            "pos", _pos1d(hidden, motion_num_token * (motion_frames + 1)),
            persistent=False)
        self.register_buffer("extra_pos", _pos1d(hidden, motion_frames),
                             persistent=False)
        block = (JointBlock2ConditionSimple if simple_adaln
                 else JointBlock2Condition)
        self.transformer_blocks = nn.ModuleList(
            [block(hidden, heads, head_dim, time_embed_dim)
             for _ in range(num_layers)])
        self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
        self.norm_out = AdaLayerNorm(hidden, time_embed_dim)
        self.proj_out = nn.Linear(hidden, out_channels)

    def forward(self, motion, ref_motion, extra, timestep):
        """motion (N, F, L, D), ref_motion (N, L, D), extra (N, F, De),
        timestep (N,) -> velocity (N, F, L, out_channels)."""
        n, f, l, d = motion.shape
        _check_tokens(self, l, f)
        if f > self.motion_frames:
            raise ValueError(f"A2M head: {f} frames; its audio position "
                             f"table holds motion_frames "
                             f"{self.motion_frames}")
        dtype = self.proj_out.weight.dtype
        emb = self.time_embedding(timestep)
        motion = self.motion_patch_embed(motion.reshape(n, f * l, d).to(dtype))
        ref = self.refmotion_patch_embed(ref_motion.to(dtype))
        extra = self.extra_embed(extra.to(dtype)) + self.extra_pos[:, :f]
        ref = ref + self.pos[:, :l]
        motion = motion + self.pos[:, l:l + f * l]
        for block in self.transformer_blocks:
            motion, ref, extra = block(motion, ref, extra, emb)
        motion = self.norm_out(self.norm_final(motion), emb)
        return self.proj_out(motion).reshape(n, f, l, -1)


class A2PTransformer(nn.Module):
    """Audio to pose latents: the reference pose's patch tokens, then a
    learned mask token set for each further frame; per layer a
    temporal-then-spatial block and a per-frame audio cross-attention;
    unpatchified back to (N, F, C, H, W)."""

    def __init__(self, audio_in_channels: int = 128, pose_height: int = 32,
                 pose_width: int = 32, pose_inchannel: int = 4,
                 pose_patch_size: int = 4, heads: int = 8,
                 head_dim: int = 64, num_layers: int = 16):
        super().__init__()
        hidden = heads * head_dim
        p = pose_patch_size
        self.pose_inchannel, self.patch = pose_inchannel, p
        tokens = (pose_height // p) * (pose_width // p)
        self.audio_embed = nn.Linear(audio_in_channels, hidden)
        self.pose_embed = PatchEmbed(p, pose_inchannel, hidden)
        self.pose_mask_token = nn.Parameter(
            0.02 * torch.randn(1, tokens, hidden))
        self.temporal_spatial_blocks = nn.ModuleList(
            [A2PTemporalSpatialBlock(hidden, heads, head_dim)
             for _ in range(num_layers)])
        self.audio_blocks = nn.ModuleList(
            [A2PCrossAudioBlock(hidden, heads, head_dim)
             for _ in range(num_layers)])
        self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
        self.proj_out = nn.Linear(hidden, p * p * pose_inchannel)

    def forward(self, ref_pose, audio):
        """ref_pose (N, C, H, W), audio (N, F, W, Da) -> (N, F, C, H, W),
        frame 0 the reference's."""
        n, _, h, w = ref_pose.shape
        f = audio.shape[1]
        audio = self.audio_embed(audio.to(self.proj_out.weight.dtype))
        ref_tok = self.pose_embed(ref_pose)[:, None]
        mask_tok = self.pose_mask_token[None].expand(
            n, f - 1, -1, -1).to(ref_tok.dtype)
        pose = torch.cat([ref_tok, mask_tok], dim=1)
        for ts_block, audio_block in zip(self.temporal_spatial_blocks,
                                         self.audio_blocks):
            pose = audio_block(ts_block(pose), audio)
        pose = self.proj_out(self.norm_final(pose))
        out = unpatchify(pose.reshape(n * f, pose.shape[2], -1), h, w,
                         self.patch, self.pose_inchannel)
        return out.reshape(n, f, self.pose_inchannel, h, w)


class A2MModelPosePre(nn.Module):
    """Audio to motion with a jointly trained audio-to-pose predictor: the
    cross-attention denoiser's pose condition is *predicted* from the
    reference pose and the audio (``A2PTransformer``), so serving needs
    one reference pose frame. Training adds the mask-weighted pose MSE to
    the velocity loss. The predictor's heads and head dim are wired by
    name, as the JAX package wires them."""

    def __init__(self, cfg: A2MConfig, device: Device = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        dev = resolve_device(device)
        with torch.device(dev):
            self.audio_encoder = AudioFeatureWindowMlp(
                c.audio_block * c.audio_inchannel, c.intermediate_dim,
                c.window_size, c.encoder_out_dim)
            self.pose_predictor = A2PTransformer(
                audio_in_channels=c.encoder_out_dim,
                pose_height=c.pose_height, pose_width=c.pose_width,
                pose_inchannel=c.pose_inchannel,
                pose_patch_size=c.pose_patch_size,
                heads=c.pose_predictor_attn_num_heads,
                head_dim=c.pose_predictor_attn_head_dim,
                num_layers=c.pose_predictor_attn_num_layers)
            self.diffusion = _cross_denoiser(c, use_audio=True, use_pose=True)
        self.to(device=dev, dtype=dtype)

    def conditions(self, audio=None, ref_audio=None, pose=None,
                   ref_pose=None) -> Dict[str, torch.Tensor]:
        """``audio`` the encoded windows of cat(ref_audio, audio) (N, F+1,
        W, D); ``pose`` the predicted pose latents (N, F+1, C, h, w), the
        reference's first. ``pose`` is not read."""
        _need("A2MModelPosePre", ref_pose=ref_pose)
        feature = self.audio_encoder(torch.cat([ref_audio[:, None], audio],
                                               dim=1))
        return {"audio": feature,
                "pose": self.pose_predictor(ref_pose, feature)}

    def predict_pose(self, audio, ref_audio, ref_pose) -> torch.Tensor:
        """The predicted pose latents (N, F+1, C, h, w) alone."""
        return self.conditions(audio, ref_audio, ref_pose=ref_pose)["pose"]

    def velocity(self, zt, ref_motion, timestep, **cond) -> torch.Tensor:
        return self.diffusion(zt, ref_motion, timestep=timestep, **cond)

    def forward(self, motion_gt, ref_motion, audio=None, ref_audio=None,
                pose=None, ref_pose=None, mask=None,
                timestep: Optional[torch.Tensor] = None,
                z0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The velocity loss of ``A2MModelCrossAttnAudio.forward`` plus the
        mask-weighted MSE of the predicted pose frames against ``pose``
        (N, F, C, h, w). Returns {loss, diff_loss, pose_loss}."""
        cond = self.conditions(audio, ref_audio, ref_pose=ref_pose)
        diff = _velocity_loss(self, motion_gt, ref_motion, cond, mask,
                              timestep, z0, generator)
        if mask is None:
            mask = torch.ones(motion_gt.shape[:2], device=motion_gt.device)
        pose_loss = _masked_mse(cond["pose"][:, 1:], pose, mask)
        return {"loss": diff + pose_loss, "diff_loss": diff,
                "pose_loss": pose_loss}


class A2MModelLearnableToken(nn.Module):
    """The joint three-stream A2M head over per-frame MLP audio features
    (``A2MModel_LearnableToken``; ``simple_adaln`` for
    ``A2MModel_SimpleAdaLN``). It reads ``audio`` (N, F, M, C) only: no
    reference audio, no pose."""

    def __init__(self, cfg: A2MConfig, simple_adaln: bool = False,
                 device: Device = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        dev = resolve_device(device)
        with torch.device(dev):
            self.audio_encoder = AudioFeatureMlp(
                c.audio_block * c.audio_inchannel, c.encoder_out_dim)
            self.diffusion = A2MJointTransformer(
                motion_num_token=c.motion_num_token,
                motion_inchannel=c.motion_in_channel,
                motion_frames=c.motion_frames,
                extra_in_channels=c.encoder_out_dim,
                out_channels=c.motion_in_channel,
                heads=c.diffusion_attn_num_heads,
                head_dim=c.diffusion_attn_head_dim,
                num_layers=c.diffusion_num_layers, simple_adaln=simple_adaln)
        self.to(device=dev, dtype=dtype)

    def conditions(self, audio=None, **_) -> Dict[str, torch.Tensor]:
        return {"audio_feature": self.audio_encoder(audio)}

    def velocity(self, zt, ref_motion, timestep,
                 audio_feature=None) -> torch.Tensor:
        return self.diffusion(zt, ref_motion, audio_feature, timestep)

    def forward(self, motion_gt, ref_motion, audio, ref_audio=None,
                mask=None, timestep: Optional[torch.Tensor] = None,
                z0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The masked velocity MSE, as ``A2MModelCrossAttnAudio.forward``;
        ``ref_audio`` is not read."""
        loss = _velocity_loss(self, motion_gt, ref_motion,
                              self.conditions(audio), mask, timestep, z0,
                              generator)
        return {"loss": loss, "diff_loss": loss}


class Audio2MotionGridDiT(nn.Module):
    """Three-stream grid-motion denoiser: the patchified motion grids of F
    frames with a 3-D sincos table, the channel-concatenated (reference
    image | pose) patch tokens with a 2-D table, and the per-frame audio
    features, through ``JointBlock2Condition`` blocks and an AdaLN head
    unpatchified to (N, F, C, h, w). The 3-D table is built over (mph,
    mph) patches, whatever the grid's width, as in the JAX package."""

    def __init__(self, heads: int = 16, head_dim: int = 64,
                 motion_in_channels: int = 256, refimg_in_channels: int = 4,
                 extra_in_channels: int = 768, out_channels: int = 256,
                 num_layers: int = 8, image_height: int = 32,
                 image_width: int = 32, image_patch_size: int = 2,
                 motion_patch_size: int = 1, time_embed_dim: int = 512):
        super().__init__()
        hidden = heads * head_dim
        self.hidden, self.out_channels = hidden, out_channels
        self.patch = motion_patch_size
        self.time_embedding = TimestepEmbedding(hidden, time_embed_dim)
        self.motion_patch_embed = PatchEmbed(motion_patch_size,
                                             motion_in_channels, hidden)
        self.refimg_pose_patch_embed = PatchEmbed(
            image_patch_size, 2 * refimg_in_channels, hidden)
        self.register_buffer("img_pos", _pos2d(
            hidden, image_height, image_width, image_patch_size),
            persistent=False)
        self.extra_embed = nn.Linear(extra_in_channels, hidden)
        self.transformer_blocks = nn.ModuleList(
            [JointBlock2Condition(hidden, heads, head_dim, time_embed_dim)
             for _ in range(num_layers)])
        self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
        self.norm_out = AdaLayerNorm(hidden, time_embed_dim)
        self.proj_out = nn.Linear(hidden, motion_patch_size ** 2 *
                                  out_channels)
        self._mot_pos: Dict[tuple, torch.Tensor] = {}

    def _motion_pos(self, f, mph, mpw, like) -> torch.Tensor:
        key = (f, mph, mpw, like.device, like.dtype)
        if key not in self._mot_pos:
            table = emb_ops.get_3d_sincos_pos_embed(self.hidden, (mph, mph),
                                                    f)
            self._mot_pos[key] = torch.from_numpy(table.reshape(
                1, -1, self.hidden)[:, :f * mph * mpw].copy()).to(like)
        return self._mot_pos[key]

    def forward(self, motion_hidden_states, refimg_hidden_states,
                pose_hidden_states, extra_hidden_states, timestep):
        """motion (N, F, Cm, Hm, Wm), refimg/pose (N, C, H, W), extra (N,
        F, D), timestep (N,) -> velocity (N, F, Cm, Hm, Wm)."""
        n, f, cm, hm, wm = motion_hidden_states.shape
        p = self.patch
        mph, mpw = hm // p, wm // p
        emb = self.time_embedding(timestep)
        motion = self.motion_patch_embed(
            motion_hidden_states.reshape(n * f, cm, hm, wm))
        motion = motion.reshape(n, f * mph * mpw, self.hidden)
        motion = motion + self._motion_pos(f, mph, mpw, motion)
        ref_pose = self.refimg_pose_patch_embed(torch.cat(
            [refimg_hidden_states, pose_hidden_states], dim=1)) + self.img_pos
        extra = self.extra_embed(extra_hidden_states.to(motion.dtype))
        for block in self.transformer_blocks:
            motion, ref_pose, extra = block(motion, ref_pose, extra, emb)
        x = self.proj_out(self.norm_out(self.norm_final(motion), emb))
        out = unpatchify(x.reshape(n * f, mph * mpw, -1), hm, wm, p,
                         self.out_channels)
        return out.reshape(n, f, self.out_channels, hm, wm)


class A2MModelMlp(nn.Module):
    """The grid-motion A2M head: MLP audio features and the grid DiT,
    trained with the rectified-flow velocity MSE over (N, F, C, h, w)
    motion grids; ``sample_grid`` samples it."""

    def __init__(self, cfg: A2MConfig, device: Device = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        dev = resolve_device(device)
        with torch.device(dev):
            self.audio_encoder = AudioFeatureMlp(
                c.audio_block * c.audio_inchannel, c.encoder_out_dim)
            self.diffusion = Audio2MotionGridDiT(
                heads=c.diffusion_attn_num_heads,
                head_dim=c.diffusion_attn_head_dim,
                motion_in_channels=c.motion_in_channel,
                refimg_in_channels=c.image_inchannel,
                extra_in_channels=c.encoder_out_dim,
                out_channels=c.motion_in_channel,
                num_layers=c.diffusion_num_layers,
                image_height=c.image_height, image_width=c.image_width,
                image_patch_size=c.image_patch_size,
                motion_patch_size=c.motion_patch_size,
                time_embed_dim=c.time_embed_dim)
        self.to(device=dev, dtype=dtype)

    def encode_audio(self, audio) -> torch.Tensor:
        return self.audio_encoder(audio)

    def velocity(self, zt, ref_img, ref_pose, audio_feature,
                 timestep) -> torch.Tensor:
        return self.diffusion(zt, ref_img, ref_pose, audio_feature, timestep)

    def forward(self, motion_gt, ref_img, audio, pose=None, ref_pose=None,
                time_step: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The velocity MSE of ``motion_gt`` (N, F, C, h, w) with the
        reference image latents (N, C, H, W), ``audio`` (N, F, M, D) and
        ``ref_pose`` (zeros where None); ``pose`` is not read. The
        timestep and the noise are drawn from ``generator`` (in that
        order) where not given. Returns {loss, diff_loss}."""
        if ref_pose is None:
            ref_pose = torch.zeros_like(ref_img)
        feature = self.encode_audio(audio)
        time_step, noise = _flow_draws(self.cfg, motion_gt.shape,
                                       motion_gt.dtype, motion_gt.device,
                                       time_step, noise, generator)
        t = rf.timestep_to_time(time_step, self.cfg.num_step,
                                ndim=motion_gt.dim())
        zt = t * motion_gt + (1.0 - t) * noise
        vel = self.velocity(zt, ref_img, ref_pose, feature,
                            time_step.float())
        loss = (vel.float() - (motion_gt - noise).float()).square().mean()
        return {"loss": loss, "diff_loss": loss}


@torch.no_grad()
def sample_grid(model: A2MModelMlp, ref_img, audio, ref_pose=None,
                sample_step: int = 10,
                generator: DrawSource = None) -> torch.Tensor:
    """Euler-sample a (N, F, C, h, w) motion grid from ``audio`` (N, F, M,
    D) and the reference image latents (N, C, H, W): the start noise (fp32)
    from ``generator`` (a ``torch.Generator`` or ``SampleDraws``)."""
    c = model.cfg
    if ref_pose is None:
        ref_pose = torch.zeros_like(ref_img)
    feature = model.encode_audio(audio)
    z0 = sample_draws(generator).normal(
        (ref_img.shape[0], audio.shape[1], c.motion_in_channel,
         c.motion_height, c.motion_width), torch.float32, ref_img.device)
    step_seq = rf.sample_step_sequence(sample_step, c.num_step)

    def vel_fn(zt, tstep):
        return model.velocity(zt, ref_img, ref_pose, feature, tstep)

    return rf.euler_sample(vel_fn, z0, step_seq)


@torch.no_grad()
def sample(model, ref_motion, frames: int,
           sample_step: int = 10, audio=None, ref_audio=None, pose=None,
           ref_pose=None, solver: str = "euler",
           generator: DrawSource = None, quant_table=None) -> torch.Tensor:
    """Motion tokens (N, frames, L, D) for ``ref_motion`` (N, L, D) and the
    window's conditions, for any motion-token head (its ``conditions`` and
    ``velocity``; a head reads the inputs it needs): the start noise (N,
    frames, L, D) from ``generator`` (a ``torch.Generator`` or
    ``SampleDraws``), then an ODE walk with ``solver`` ("euler", or
    "heun": two velocity calls a step).
    ``quant_table`` (``ops.quant.quantize_params`` of ``model`` with scope
    ``("diffusion",)``) runs the walk's large projections in int8; the
    conditions are computed once, outside it, in the compute dtype."""
    solvers = {"euler": rf.euler_sample, "heun": rf.heun_sample}
    if solver not in solvers:
        raise ValueError(f"unknown solver {solver!r}; use 'euler' or 'heun'")
    n, l, d = ref_motion.shape
    cond = model.conditions(audio=audio, ref_audio=ref_audio, pose=pose,
                            ref_pose=ref_pose)
    z0 = sample_draws(generator).normal((n, frames, l, d), ref_motion.dtype,
                                        ref_motion.device)
    step_seq = rf.sample_step_sequence(sample_step, None, model.cfg.num_step)

    def vel_fn(zt, tstep):
        return model.velocity(zt, ref_motion, tstep, **cond)

    with quant_ops.maybe_quantized(model, quant_table):
        return solvers[solver](vel_fn, z0, step_seq)
