"""The audio-to-motion head (port of ``A2MTransformerCrossAttnAudio``,
``A2MConfig``, ``A2MModelCrossAttnAudio`` and ``sample`` of
``hivae_tpu/models/a2m.py``).

``A2MModelCrossAttnAudio`` predicts the AMD model's object-motion tokens
(N, F, L, D) of an F-frame window from per-frame audio features (whisper
embeddings, (N, F, M, C)), the pose latents, or both (``variant`` "audio",
"pose" or "audio_pose"), conditioned on the reference frame's tokens and
audio. Its denoiser alternates, per layer, a joint self-attention block
over [reference; motion] and a per-frame cross-attention block over each
frame's condition window; a rectified-flow walk (``sample``) draws the
tokens. Its attentions (1 + F frames of L tokens; L queries against a
window of W keys) stay under 256^2 logits, so ``ops.attention.sdpa``
sends them to its plain path, as the JAX package sends them to XLA.

The 1-D sincos table of the motion positions holds ``motion_num_token *
(motion_frames + 1)`` rows; a call with more tokens a window, L * (F + 1),
is refused with a ``ValueError`` naming both counts, where the JAX package
fails on a broadcast. ``motion_num_token`` sizes only that table, so the
head pairs with an AMD model whose ``object_motion_token_num`` is L when
``motion_num_token`` is at least L.

The training forward's timestep and flow noise can be injected; what is
not is drawn from the caller's generator in the JAX package's order
(timestep, then noise). ``sample`` draws its start noise through
``models.amd.SampleDraws``. The other heads of the JAX module
(``A2MModelPosePre``, ``A2MModelLearnableToken``, ``Audio2MotionGridDiT``,
``A2MModelMlp``, ``sample_grid``) are not ported yet (ROADMAP.md Queue 1
#7b).
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
from .blocks import (A2MCrossAttnBlock, A2MMotionSelfAttnBlock, AdaLayerNorm,
                     AudioFeatureWindowMlp, PatchEmbed, TimestepEmbedding)
from .dit import _pos1d, _pos2d

Device = Optional[Union[str, torch.device]]
VARIANTS = ("audio", "audio_pose", "pose")


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
        """Refuse L tokens a frame over F frames and the reference where
        the position table is shorter than L * (F + 1)."""
        rows = self.pos.shape[1]
        if tokens * (frames + 1) > rows:
            raise ValueError(
                f"A2M head: {tokens} motion tokens a frame over {frames} "
                f"frames and the reference need {tokens * (frames + 1)} "
                f"positions; its table holds motion_num_token "
                f"{self.motion_num_token} x (motion_frames "
                f"{self.motion_frames} + 1) = {rows}. Set motion_num_token "
                f"to the AMD model's object_motion_token_num ({tokens})")

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
            self.diffusion = A2MTransformerCrossAttnAudio(
                motion_num_token=c.motion_num_token,
                motion_inchannel=c.motion_in_channel,
                motion_frames=c.motion_frames,
                audio_in_channels=c.encoder_out_dim,
                out_channels=c.motion_in_channel,
                heads=c.diffusion_attn_num_heads,
                head_dim=c.diffusion_attn_head_dim,
                num_layers=c.diffusion_num_layers, use_pose=self.use_pose,
                pose_inchannel=c.pose_inchannel,
                pose_patch_size=c.pose_patch_size,
                pose_height=c.pose_height, pose_width=c.pose_width,
                use_audio=self.use_audio)
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
        c = self.cfg
        n, f = motion_gt.shape[:2]
        dev = motion_gt.device
        cond = self.conditions(audio, ref_audio, pose, ref_pose)
        if timestep is None:
            timestep = torch.randint(0, c.num_step + 1, (n,),
                                     generator=generator, device=dev)
        if z0 is None:
            z0 = torch.randn(motion_gt.shape, generator=generator,
                             dtype=motion_gt.dtype, device=dev)
        zt, vel_gt = rf.get_train_tuple(motion_gt, timestep, z0,
                                        num_steps=c.num_step)
        vel_pred = self.velocity(zt, ref_motion, timestep.float(), **cond)
        if mask is None:
            mask = torch.ones((n, f), device=dev)
        diff = (vel_pred.float() - vel_gt.float()).square().mean(dim=(2, 3))
        loss = (diff * mask).sum() / mask.sum()
        return {"loss": loss, "diff_loss": loss}


@torch.no_grad()
def sample(model: A2MModelCrossAttnAudio, ref_motion, frames: int,
           sample_step: int = 10, audio=None, ref_audio=None, pose=None,
           ref_pose=None, solver: str = "euler",
           generator: DrawSource = None, quant_table=None) -> torch.Tensor:
    """Motion tokens (N, frames, L, D) for ``ref_motion`` (N, L, D) and the
    window's conditions: the start noise (N, frames, L, D) from
    ``generator`` (a ``torch.Generator`` or ``SampleDraws``), then an ODE
    walk with ``solver`` ("euler", or "heun": two velocity calls a step).
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
