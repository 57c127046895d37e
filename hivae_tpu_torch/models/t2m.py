"""The label/text-to-motion head (port of ``hivae_tpu/models/t2m.py``).

``Label2MotionDiffusionDecoder`` denoises an AMD model's object-motion
tokens (rectified flow) conditioned on a label, the camera target motion
and the reference image latents: a label embedding (an int label indexes
the ``label_embedding`` table, a float (N, label_dim) one, e.g. a text
embedding of ``data.text.TextEncoder``, goes straight to
``label_proj_in``) is added to the timestep embedding; per layer a motion
``DiTBlock`` over [object tokens, alignment token(s), camera tokens], then
a joint ``DiTBlock`` over [motion tokens, 256 image patches].

At the default ``T2MConfig`` (16 heads of 128, 20 layers) the joint block
runs over 16 + 1 + 8 + 256 = 281 tokens (298 with an object source; 269
with AMD_N's 4 object tokens): above 256^2 logits, so ``ops.attention.sdpa``
sends it to the full-block kernel at head dim 128. The motion blocks (25
tokens) stay on the plain path, as in the JAX package.

Kept from the JAX package on purpose: the conditioning ``emb`` and the
flow time are tiled frame-major over the N*T rows (``Tensor.repeat(t, 1)``:
row r takes sample r % N), while the image, camera and object rows are
batch-major (row i*T + j), so for N >= 2 a frame is conditioned on another
sample's label and timestep, as a trained checkpoint expects. Over
data-parallel ranks the tile is the global batch's, as under the JAX
package's sharded step: a rank passes the global labels and timesteps and
``rows``, its window of the global N*T rows.

The flow noise (``noise``) and ``sample``'s start noise (``z0``) are
inputs; a missing one is drawn from the caller's generator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops import rectified_flow as rf
from ..utils.device import resolve_device
from .blocks import DiTBlock, Mlp, PatchEmbed, TimestepEmbedding
from .dit import _pos2d

Device = Any


@dataclasses.dataclass(frozen=True)
class T2MConfig:
    label_dim: int = 512
    num_classes: int = 101           # UCF-101
    # must equal object_channel: the predicted velocity lives in
    # object-motion-token space
    motion_dim: int = 32
    refimg_width: int = 32
    refimg_height: int = 32
    refimg_patch_size: int = 2
    refimg_dim: int = 4
    num_frames: int = 16
    num_steps: int = 1000
    time_embed_dim: int = 768
    attention_head_dim: int = 128
    num_attention_heads: int = 16
    num_layers: int = 20
    camera_token_num: int = 8
    object_token_num: int = 16
    camera_channel: int = 8
    object_channel: int = 32

    @classmethod
    def from_dict(cls, d):
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def to_dict(self):
        return dataclasses.asdict(self)


class Label2MotionDiffusionDecoder(nn.Module):
    """The T2M denoiser; ``forward`` takes camera_target (N, T, S, Cc),
    object_target (N*T, L, Co), label (N,) int or (N, label_dim) float,
    ref_img (N, T, C, H, W) latents and timestep (N,)."""

    def __init__(self, cfg: T2MConfig, device: Device = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.motion_dim != cfg.object_channel:
            raise ValueError(
                f"T2MConfig.motion_dim ({cfg.motion_dim}) must equal "
                f"object_channel ({cfg.object_channel}): the predicted "
                "velocity lives in object-motion-token space")
        self.cfg = c = cfg
        hidden = self.hidden = c.num_attention_heads * c.attention_head_dim
        dev = resolve_device(device)
        with torch.device(dev):
            self.label_embedding = nn.Parameter(
                torch.randn(c.num_classes, c.label_dim) * 0.02)
            self.patch_embed = PatchEmbed(c.refimg_patch_size, c.refimg_dim,
                                          hidden)
            self.label_proj_in = Mlp(c.label_dim, hidden, hidden)
            self.time_embedding = TimestepEmbedding(c.time_embed_dim, hidden)
            self.camera_proj_in = nn.Linear(c.camera_channel,
                                            c.object_channel)
            self.motion_align_c = nn.Parameter(torch.zeros(1, c.object_channel))
            self.motion_align_o = nn.Parameter(torch.zeros(1, c.object_channel))
            self.motion_proj_in = Mlp(c.object_channel, hidden, hidden)

            def blocks():
                return nn.ModuleList(
                    [DiTBlock(hidden, c.num_attention_heads,
                              c.attention_head_dim, hidden)
                     for _ in range(c.num_layers)])
            self.motion_blocks = blocks()
            self.image_blocks = blocks()
            self.norm_final = nn.LayerNorm(hidden, eps=1e-5)
            self.proj_out = nn.Linear(hidden, c.motion_dim)
            self.camera_proj_out = nn.Linear(c.motion_dim, c.camera_channel)
        self.register_buffer("pos", _pos2d(hidden, c.refimg_height,
                                           c.refimg_width,
                                           c.refimg_patch_size),
                             persistent=False)
        self.to(device=dev, dtype=dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.proj_out.weight.dtype

    def embed_label(self, label: torch.Tensor) -> torch.Tensor:
        """(N,) int labels -> (N, label_dim); a float label passes."""
        if label.dim() == 1 and not label.is_floating_point():
            return self.label_embedding[label.long()]
        return label.to(self.dtype)

    def forward(self, camera_target_motion, object_target_motion, label,
                ref_img, timestep, object_source_motion=None,
                noise: Optional[torch.Tensor] = None,
                object_noisy: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                rows: Optional[slice] = None) -> Dict[str, torch.Tensor]:
        """``rows``: the motion and image rows are rows ``rows`` of a
        larger batch's N*T, whose ``label`` and ``timestep`` are given
        (the frame-major tile then picks the global batch's sample)."""
        c = self.cfg
        dtype = self.dtype
        n, t = ref_img.shape[:2]
        img = self.patch_embed(ref_img.reshape((n * t,) + ref_img.shape[2:])
                               .to(dtype))
        img = img + self.pos.to(img.dtype)

        label_emb = self.label_proj_in(self.embed_label(label))
        timestep = timestep.float()
        temb = self.time_embedding(timestep)
        # frame-major tile: row r is sample r % n (see the module note)
        if rows is None:
            emb = (temb + label_emb).repeat(t, 1)
        else:
            pick = torch.arange(rows.start, rows.stop,
                                device=temb.device) % temb.shape[0]
            emb = (temb + label_emb)[pick]

        cam = camera_target_motion.reshape(
            (-1,) + camera_target_motion.shape[2:]).to(dtype)
        cam = self.camera_proj_in(cam)

        step = (1.0 - timestep / c.num_steps)[:, None, None]
        step = step.repeat(t, 1, 1) if rows is None else step[pick]
        if object_noisy is not None:
            obj_zt = object_noisy
            vel_gt_object = torch.zeros_like(obj_zt)
        else:
            if noise is None:
                noise = torch.randn(object_target_motion.shape,
                                    generator=generator,
                                    device=object_target_motion.device,
                                    dtype=object_target_motion.dtype)
            noise = noise.to(object_target_motion)
            vel_gt_object = object_target_motion - noise
            obj_zt = step * object_target_motion + (1 - step) * noise

        bo = obj_zt.shape[0]
        align_c = self.motion_align_c[None].expand(bo, 1, c.object_channel)
        parts = [obj_zt.to(dtype)]
        if object_source_motion is not None:
            align_o = self.motion_align_o[None].expand(bo, 1,
                                                       c.object_channel)
            parts += [align_o, object_source_motion.to(dtype)]
        motion = torch.cat(parts + [align_c, cam], dim=1)
        x = self.motion_proj_in(motion)
        msl = x.shape[1]

        for motion_block, image_block in zip(self.motion_blocks,
                                             self.image_blocks):
            x = motion_block(x, emb)
            joint = image_block(torch.cat([x, img.to(x.dtype)], dim=1), emb)
            x = joint[:, :msl]

        x = self.proj_out(self.norm_final(x))
        otn = c.object_token_num
        vel_pred_object = x[:, :otn]
        skip = 2 * otn + 2 if object_source_motion is not None else otn + 1
        vel_pred_camera = self.camera_proj_out(x[:, skip:])
        return {"vel_pred_camera": vel_pred_camera,
                "object_motion_with_noise": obj_zt,
                "vel_pred_object": vel_pred_object,
                "vel_gt_object": vel_gt_object}

    @staticmethod
    def loss(outputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        d = (outputs["vel_pred_object"].float()
             - outputs["vel_gt_object"].float())
        return torch.mean(torch.square(d))


@torch.no_grad()
def sample(model: Label2MotionDiffusionDecoder, label, ref_img,
           camera_target_motion, sample_steps: int = 10,
           solver: str = "euler", z0: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Object-motion tokens (N*T, object_token_num, object_channel), fp32,
    conditioned on label and camera: Euler (or ``solver="heun"``) from
    ``z0`` (drawn from ``generator`` when None) over
    ``sample_step_sequence(sample_steps)``."""
    c = model.cfg
    n, t = ref_img.shape[:2]
    shape = (n * t, c.object_token_num, c.object_channel)
    if z0 is None:
        z0 = torch.randn(shape, generator=generator, device=ref_img.device)
    z0 = z0.to(device=ref_img.device, dtype=torch.float32)
    step_seq = rf.sample_step_sequence(sample_steps, c.num_steps,
                                       c.num_steps)

    def vel_fn(z, tstep):
        out = model(camera_target_motion, z, label, ref_img, tstep[:n],
                    object_noisy=z)
        return out["vel_pred_object"].float()

    integrate = rf.heun_sample if solver == "heun" else rf.euler_sample
    return integrate(vel_fn, z0, step_seq)
