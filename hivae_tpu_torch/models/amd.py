"""The AMD models: frequency-decoupled motion autoencoding with a
rectified-flow DiT decoder (port of ``CameraDown``, ``AMDModelNew``,
``AMDModel``, ``AMDModelRec``, their training forwards, the factories and
``AMD_MODELS``, and the sampling drivers ``sample``, ``decode``,
``sample_with_refimg_motion``, ``sample_cross``, ``sample_diff_motion``,
``extract_motion`` and ``_euler_decode`` of ``hivae_tpu/models/amd.py``).
``AMD_CLASSES`` names the class each factory builds, which a model type's
``config.json`` is loaded into.

``AMDModelNew`` (AMD_N, and AMD_S_Camera with the object stream off): the
camera stream is the temporal-cross encoder on the low-pass (grey) band,
the object stream the spatial encoder on RGB, the decoder
``VelocityDiTImgSpatialTempMotion`` (``diffusion_model_type="spatial"``) or
``VelocityDiTTempMotion`` (``"default"``, object stream only). The config
flags the JAX ``AMDModelNew`` builds are built here too: ``use_camera_down``
(the camera encoder on a 4x smaller grid), ``need_motion_transformer`` (the
motion-sequence transformer of ``extract_motion`` and refimg-motion
sampling) and ``use_mask`` (the optical-flow camera mask on the low band).
``use_regularizers`` is accepted there and has no effect, as in the JAX
``AMDModelNew``.

``AMDModel`` (AMD_S, AMD_L) is the dual-encoder model: object and camera
encoders over cat(reference, video) (high and low band under
``use_filter``), source/target halves projected to one motion channel,
the targets through a KL bottleneck under ``use_regularizers``, and one of
three DiTs (``default``, ``dual``, ``spatial``); ``sample_diff_motion``
takes its camera stream from another clip. ``AMDModelRec`` (AMD_S_Rec,
AMD_S_RecSplit) regresses the target latents without a timestep; it has a
forward and a loss only, as in the JAX package.

``AMDConfig`` keeps the JAX package's schema so its ``config.json`` files
load unchanged. ``remat`` checkpoints the DiT layers under autograd with
``remat_policy``; ``attn_impl`` (auto, xla, pallas, ring) is installed
process-wide by the trainer and the inference CLIs
(``ops.attention.install_attn_impl``), as in the JAX package;
``scan_layers``, which only shapes JAX compilation, is accepted and has no
effect here.

Every random draw of a training forward (mask-ratio jitter, token
permutations, KL posterior noise, timesteps, flow noise) can be injected
through ``TrainDraws``; what is not injected is drawn from the caller's
``torch.Generator`` in the JAX package's order. The sampling drivers draw
through ``SampleDraws``: from a generator, or replayed from tensors drawn
elsewhere.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..losses.losses import l2
from ..ops import frequency
from ..ops import quant as quant_ops
from ..ops import rectified_flow as rf
from ..ops.regularizers import diagonal_gaussian_regularize
from ..utils.device import resolve_device
from ..utils.misc import no_grad
from .dit import (ReconstructionDiT, VelocityDiT, VelocityDiTDualStream,
                  VelocityDiTImgSpatial, VelocityDiTImgSpatialTempMotion,
                  VelocityDiTTempMotion, sum_streams)
from .motion_encoders import (MotionEncoderSpatial,
                              MotionEncoderSpatialTemporal,
                              MotionEncoderTemporalCross,
                              MotionSequenceTransformer)


@dataclasses.dataclass(frozen=True)
class AMDConfig:
    """Mirror of the JAX package's ``AMDConfig`` (same fields, defaults and
    dict schema)."""

    image_inchannel: int = 4
    image_height: int = 32
    image_width: int = 32
    video_frames: int = 16
    scheduler_num_step: int = 1000
    use_filter: bool = False
    filter_num: float = 0.4
    high_filter_num: float = 0.6
    use_grey: bool = False
    use_camera_down: bool = False
    use_regularizers: bool = False
    use_motiontemporal: bool = True
    klloss_weight: float = 0.005
    use_mask: bool = False
    motion_type: str = "plus"
    use_camera: bool = True
    use_object: bool = True
    object_motion_token_num: int = 12
    object_motion_token_channel: int = 128
    object_enc_num_layers: int = 8
    enc_nhead: int = 8
    enc_ndim: int = 64
    motion_need_norm_out: bool = False
    camera_motion_token_num: int = 12
    camera_motion_token_channel: int = 128
    camera_enc_num_layers: int = 8
    motion_token_num: int = 12
    motion_token_channel: int = 128
    need_motion_transformer: bool = False
    motion_transformer_attn_head_dim: int = 64
    motion_transformer_attn_num_heads: int = 16
    motion_transformer_num_layers: int = 4
    diffusion_model_type: str = "default"
    diffusion_attn_head_dim: int = 64
    diffusion_attn_num_heads: int = 16
    diffusion_out_channels: int = 4
    diffusion_num_layers: int = 16
    image_patch_size: int = 2
    motion_patch_size: int = 1
    extract_motion_with_motion_transformer: bool = False
    remat: bool = False
    remat_policy: str = "full"
    scan_layers: bool = False
    attn_impl: str = "auto"        # see ops.attention.install_attn_impl

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AMDConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "AMDConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class TrainDraws:
    """The random draws of one training forward; ``None`` entries are
    drawn from the generator. ``time_step`` (N*T,) integer steps in
    [0, num_steps], repeated over each clip's frames; ``z0`` the flow noise
    (N*T, C, h, w); ``camera_u``/``object_u`` the uniforms of the mask-ratio
    jitter; ``camera_perm`` (N, sites) and ``object_perm`` (N*2T, patches)
    the token shuffles. ``object_kl``/``camera_kl`` (N*T, D/2, L) are the
    posterior noises of the dual-encoder ``AMDModel``'s KL regulariser,
    channels first as the JAX package draws them."""

    time_step: Optional[torch.Tensor] = None
    z0: Optional[torch.Tensor] = None
    camera_u: Optional[torch.Tensor] = None
    object_u: Optional[torch.Tensor] = None
    camera_perm: Optional[torch.Tensor] = None
    object_perm: Optional[torch.Tensor] = None
    object_kl: Optional[torch.Tensor] = None
    camera_kl: Optional[torch.Tensor] = None


class SampleDraws:
    """The random tensors of a sampling call, taken in the order the call
    asks for them: the uniform draws that order the kept tokens of a
    static-ratio mask (camera before object) and the ODE start noise. Each
    is drawn from ``generator`` or, with ``replay``, is the next tensor of
    that list (draws made elsewhere, such as the JAX package's from its
    keys), which must have the shape asked for."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 replay: Optional[Sequence[Any]] = None):
        self.generator = generator
        self.replay = None if replay is None else list(replay)

    def _next(self, shape, device, dtype) -> torch.Tensor:
        if not self.replay:
            raise ValueError(f"no replayed draw left for shape {shape}")
        t = self.replay.pop(0)
        t = t if torch.is_tensor(t) else torch.from_numpy(np.array(t))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"replayed draw has shape {tuple(t.shape)}, "
                             f"the call asks for {tuple(shape)}")
        return t.to(device=device, dtype=dtype)

    def uniform(self, shape, device) -> torch.Tensor:
        if self.replay is not None:
            return self._next(shape, device, torch.float32)
        return torch.rand(shape, generator=self.generator, device=device)

    def normal(self, shape, dtype, device) -> torch.Tensor:
        if self.replay is not None:
            return self._next(shape, device, dtype)
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=device)


DrawSource = Union[None, torch.Generator, SampleDraws]


def sample_draws(generator: DrawSource) -> SampleDraws:
    """``generator`` (None, a ``torch.Generator`` or ``SampleDraws``) as
    ``SampleDraws``."""
    if isinstance(generator, SampleDraws):
        return generator
    return SampleDraws(generator)


def _band_split(x_nthw: torch.Tensor, d_low: float, d_high: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,T,C,H,W) -> (low(d_low), high(d_high)) band videos, split over
    (T, H, W)."""
    x = x_nthw.transpose(1, 2)  # n c t h w
    low, _ = frequency.freq_3d_split(x, d_low, d_low)
    _, high = frequency.freq_3d_split(x, d_high, d_high)
    return low.transpose(1, 2), high.transpose(1, 2)


class CameraDown(nn.Module):
    """Strided conv + max-pool camera downsampler: (B, C, H, W) ->
    (B, 4, H/4, W/4)."""

    def __init__(self, in_channels: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 16, 3, stride=2, padding=1)
        self.conv2 = nn.Conv2d(16, 4, 3, stride=1, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(self.conv2(self.conv1(x)), 2, 2)


class AMDModelNew(nn.Module):
    """Decoupled-motion video model (camera + object streams)."""

    def __init__(self, cfg: AMDConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.diffusion_model_type not in ("default", "spatial"):
            raise ValueError(f"diffusion_model_type "
                             f"{cfg.diffusion_model_type!r}")
        self.cfg = c = cfg
        dev = resolve_device(device)
        down = 4 if c.use_camera_down else 1
        with torch.device(dev):
            if c.use_camera:
                self.camera_motion_encoder = MotionEncoderTemporalCross(
                    img_height=c.image_height // down,
                    img_width=c.image_width // down,
                    img_inchannel=c.image_inchannel,
                    img_patch_size=c.image_patch_size,
                    motion_token_num=c.camera_motion_token_num,
                    motion_channel=c.camera_motion_token_channel,
                    need_norm_out=c.motion_need_norm_out,
                    video_frames=c.video_frames, heads=c.enc_nhead,
                    head_dim=c.enc_ndim, num_layers=c.camera_enc_num_layers)
            if c.use_object:
                self.object_motion_encoder = MotionEncoderSpatial(
                    img_height=c.image_height, img_width=c.image_width,
                    img_inchannel=c.image_inchannel,
                    img_patch_size=c.image_patch_size,
                    motion_token_num=c.object_motion_token_num,
                    motion_channel=c.object_motion_token_channel,
                    need_norm_out=c.motion_need_norm_out,
                    heads=c.enc_nhead, head_dim=c.enc_ndim,
                    num_layers=c.object_enc_num_layers)
            if c.use_camera_down:
                self.camera_down = CameraDown(c.image_inchannel)
            if c.need_motion_transformer:
                self.motion_transformer = MotionSequenceTransformer(
                    motion_token_num=c.motion_token_num,
                    motion_token_channel=c.motion_token_channel,
                    heads=c.motion_transformer_attn_num_heads,
                    head_dim=c.motion_transformer_attn_head_dim,
                    num_layers=c.motion_transformer_num_layers)
            dit_kw = dict(heads=c.diffusion_attn_num_heads,
                          head_dim=c.diffusion_attn_head_dim,
                          out_channels=c.diffusion_out_channels,
                          num_layers=c.diffusion_num_layers,
                          image_height=c.image_height,
                          image_width=c.image_width,
                          image_patch_size=c.image_patch_size,
                          image_in_channels=c.image_inchannel * 2,
                          motion_target_num_frame=c.video_frames,
                          object_motion_in_channels=
                          c.object_motion_token_channel,
                          remat=c.remat, remat_policy=c.remat_policy)
            if c.diffusion_model_type == "default":
                self.diffusion_transformer = VelocityDiTTempMotion(**dit_kw)
            else:
                self.diffusion_transformer = VelocityDiTImgSpatialTempMotion(
                    motion_token_num=c.motion_token_num,
                    use_camera=c.use_camera, use_object=c.use_object,
                    camera_motion_in_channels=c.camera_motion_token_channel,
                    **dit_kw)
        # position tables are built on the host; move them with the weights
        self.to(device=dev, dtype=dtype)

    # the methods the samplers call in place of forward; under FSDP2 each
    # gathers the root's parameters as a forward does
    fsdp_forward_methods = ("encode", "velocity", "extract_motion",
                            "camera_input")

    def fsdp_units(self):
        """The modules FSDP2 shards as units of their own (before the model
        itself): every motion-encoder block and every DiT block."""
        for name in ("camera_motion_encoder", "object_motion_encoder",
                     "motion_transformer"):
            if hasattr(self, name):
                yield from getattr(self, name).transformer_blocks
        dit = self.diffusion_transformer
        for name in ("camera_transformer_blocks", "object_transformer_blocks",
                     "spatial_blocks"):
            yield from getattr(dit, name, ())

    def camera_input(self, lf_video: torch.Tensor) -> torch.Tensor:
        """The camera encoder's input from a low-band video (N,T,C,H,W):
        ``CameraDown`` per frame under ``use_camera_down``."""
        return _frames_input(getattr(self, "camera_down", None), lf_video)

    def encode(self, video, ref_img, video_grey=None, ref_img_grey=None,
               camera_mask_ratio=None, object_mask_ratio=None,
               low_cut: float = 0.6, high_cut: float = 0.6,
               camera_mask=None, *, camera_perm=None, object_perm=None,
               camera_u=None, object_u=None, generator=None):
        """-> (camera_target (N,T,S,Dc), object_source (N*T,L,Do),
        object_target (N*T,L,Do)); video/ref_img: (N,T,C,H,W) latents.
        Under ``use_mask`` the low band of [ref, video] is multiplied by
        ``camera_mask`` (N, 2T, C, h, w) before the camera encoder.
        A ratio given as a 0-d tensor is the training jitter (``*_perm``
        the shuffles); with a tensor ``camera_mask_ratio`` a fourth entry,
        the camera site keep-mask (N, S), follows. A float ratio drops
        tokens (``camera_u`` (N, S) and ``object_u`` (N*2T, L) the uniform
        draws that order them)."""
        c = self.cfg
        n, t = video.shape[:2]
        refimg_and_video = torch.cat([ref_img, video], dim=1)
        if c.use_filter:
            grey = (torch.cat([ref_img_grey, video_grey], dim=1)
                    if c.use_grey else refimg_and_video)
            lf, _ = _band_split(grey, low_cut, high_cut)
            if c.use_mask and camera_mask is not None:
                lf = lf * camera_mask.to(lf)
            lf_video = lf[:, t:]
        else:
            if c.use_mask:
                raise ValueError(
                    "cfg.use_mask=True requires cfg.use_filter=True: the "
                    "camera_mask multiplies the low-frequency band, which "
                    "only exists under the FFT split")
            lf_video = video_grey if c.use_grey else video

        camera_target = object_source = object_target = site_mask = None
        if c.use_camera:
            camera_target = self.camera_motion_encoder(
                self.camera_input(lf_video), camera_mask_ratio,
                perm=camera_perm, u=camera_u, generator=generator)
            if isinstance(camera_target, tuple):
                camera_target, site_mask = camera_target
            # the camera-only variant transforms its target motion here; the
            # two-stream model runs the transformer in extract_motion and
            # refimg-motion sampling only
            if (c.need_motion_transformer and not c.use_object and
                    not c.extract_motion_with_motion_transformer):
                camera_target = self.motion_transformer(camera_target)
        if c.use_object:
            om = self.object_motion_encoder(
                refimg_and_video, object_mask_ratio, perm=object_perm,
                u=object_u, generator=generator)
            object_source = om[:, :t].reshape((n * t,) + om.shape[2:])
            object_target = om[:, t:].reshape((n * t,) + om.shape[2:])
        if site_mask is not None:
            return camera_target, object_source, object_target, site_mask
        return camera_target, object_source, object_target

    def extract_motion(self, video, mask_ratio: Optional[float] = None, *,
                       u=None, generator=None):
        """Object-motion tokens (N, T, L, D) of ``video`` (N, T, C, H, W)
        latents; a float ``mask_ratio`` drops that share of the encoder's
        patch tokens (``u`` (N*T, patches) the uniform draw that orders
        them), the GT-motion ablation's knob. With
        ``extract_motion_with_motion_transformer`` the tokens then run
        through the motion transformer."""
        motion = self.object_motion_encoder(video, mask_ratio, u=u,
                                            generator=generator)
        if (self.cfg.need_motion_transformer and
                self.cfg.extract_motion_with_motion_transformer):
            motion = self.motion_transformer(motion)
        return motion

    def velocity(self, image_hidden_states, timestep, camera_target=None,
                 object_source=None, object_target=None,
                 camera_site_mask=None):
        if self.cfg.diffusion_model_type == "default":
            # the TempMotion DiT has no camera stream
            return self.diffusion_transformer(
                image_hidden_states, timestep,
                object_motion_source=object_source,
                object_motion_target=object_target)
        return self.diffusion_transformer(
            image_hidden_states, timestep,
            camera_motion_target=camera_target,
            object_motion_source=object_source,
            object_motion_target=object_target,
            camera_site_mask=camera_site_mask)

    def forward(self, video, ref_img, video_grey=None, ref_img_grey=None,
                camera_mask_ratio=None, object_mask_ratio=None,
                return_meta_info: bool = False, camera_mask=None, *,
                draws: Optional[TrainDraws] = None,
                generator: Optional[torch.Generator] = None):
        """Training forward (JAX ``AMDModelNew.__call__``): the mask-ratio
        jitter (camera ``(0.6 + 0.4u) r``, object ``0.5u r``), motion
        encoding with band cutoffs (0.6, 0.5), a rectified-flow train tuple
        at per-clip timesteps (per-frame for the ``default`` DiT), the DiT
        velocity and the l2 losses. A ``use_mask`` model needs the
        dataset's ``camera_mask``. Returns (pre, vel, loss_dict);
        ``return_meta_info`` adds zi, zj, zt, pre, rec_zj and time_step to
        the dict."""
        c = self.cfg
        d = draws or TrainDraws()
        n, t = video.shape[:2]
        dev = video.device
        if c.use_mask and camera_mask is None:
            raise ValueError(
                "cfg.use_mask=True: the training forward requires the "
                "dataset's optical-flow camera_mask")

        def uniform(u):
            if u is None:
                u = torch.rand((), generator=generator, device=dev)
            return torch.as_tensor(u, dtype=torch.float32, device=dev)

        if camera_mask_ratio is not None:
            camera_mask_ratio = (0.6 + 0.4 * uniform(d.camera_u)) * \
                camera_mask_ratio
        if object_mask_ratio is not None:
            object_mask_ratio = (0.5 * uniform(d.object_u)) * object_mask_ratio
        encoded = self.encode(video, ref_img, video_grey, ref_img_grey,
                              camera_mask_ratio, object_mask_ratio,
                              low_cut=0.6, high_cut=0.5,
                              camera_mask=camera_mask,
                              camera_perm=d.camera_perm,
                              object_perm=d.object_perm, generator=generator)
        camera_target, object_source, object_target = encoded[:3]
        site_mask = encoded[3] if len(encoded) == 4 else None

        zi = ref_img.reshape((n * t,) + ref_img.shape[2:])
        zj = video.reshape((n * t,) + video.shape[2:])
        time_step = d.time_step
        if time_step is None:
            time_step = draw_time_steps(c, n, t, generator, dev)
        time_step = time_step.to(dev)
        z0 = d.z0
        if z0 is None:
            z0 = torch.randn(zj.shape, generator=generator, dtype=zj.dtype,
                             device=dev)
        zt, vel = rf.get_train_tuple(zj, time_step, z0.to(zj),
                                     num_steps=c.scheduler_num_step)
        pre = self.velocity(torch.cat([zi, zt], dim=1), time_step.float(),
                            camera_target, object_source, object_target,
                            camera_site_mask=site_mask)
        diff_loss = l2(pre, vel)
        rec_zj = rf.get_target_with_zt_vel(zt, pre, time_step,
                                           num_steps=c.scheduler_num_step)
        rec_loss = l2(rec_zj, zj)
        loss_dict = {"loss": diff_loss, "diff_loss": diff_loss,
                     "rec_loss": rec_loss}
        if return_meta_info:
            loss_dict.update(zi=zi, zj=zj, zt=zt, pre=pre, rec_zj=rec_zj,
                             time_step=time_step)
        return pre, vel, loss_dict


def _frames_input(down: Optional[nn.Module], video: torch.Tensor
                  ) -> torch.Tensor:
    """``CameraDown`` over each frame of (N, T, C, H, W) where ``down`` is
    a module, else the video itself."""
    if down is None:
        return video
    n, t = video.shape[:2]
    b = down(video.reshape((n * t,) + video.shape[2:]))
    return b.reshape((n, t) + b.shape[1:])


class AMDModel(nn.Module):
    """The dual-encoder AMD model (JAX ``AMDModel``): object and camera
    motion encoders over cat(reference frames, target frames), each
    split into source and target halves and projected to the shared motion
    channel (through a diagonal-Gaussian KL bottleneck on the targets under
    ``use_regularizers``), decoded by ``VelocityDiT`` (``default``),
    ``VelocityDiTDualStream`` (``dual``) or ``VelocityDiTImgSpatial``
    (``spatial``). With ``use_motiontemporal`` both encoders are
    ``MotionEncoderSpatialTemporal``; else both are spatial, the camera one
    on a 4x smaller grid (``use_camera_down`` makes that grid)."""

    def __init__(self, cfg: AMDConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.diffusion_model_type not in ("default", "dual", "spatial"):
            raise ValueError(f"diffusion_model_type "
                             f"{cfg.diffusion_model_type!r}")
        self.cfg = c = cfg
        dev = resolve_device(device)
        enc_kw = dict(img_inchannel=c.image_inchannel,
                      img_patch_size=c.image_patch_size,
                      need_norm_out=c.motion_need_norm_out,
                      heads=c.enc_nhead, head_dim=c.enc_ndim)
        with torch.device(dev):
            if c.use_motiontemporal:
                enc = cam_enc = functools.partial(
                    MotionEncoderSpatialTemporal, img_height=c.image_height,
                    img_width=c.image_width, video_frames=c.video_frames,
                    **enc_kw)
            else:
                enc = functools.partial(
                    MotionEncoderSpatial, img_height=c.image_height,
                    img_width=c.image_width, **enc_kw)
                cam_enc = functools.partial(
                    MotionEncoderSpatial, img_height=c.image_height // 4,
                    img_width=c.image_width // 4, **enc_kw)
            self.object_motion_encoder = enc(
                motion_token_num=c.object_motion_token_num,
                motion_channel=c.object_motion_token_channel,
                num_layers=c.object_enc_num_layers)
            self.camera_motion_encoder = cam_enc(
                motion_token_num=c.camera_motion_token_num,
                motion_channel=c.camera_motion_token_channel,
                num_layers=c.camera_enc_num_layers)
            if c.use_camera_down:
                self.camera_down = CameraDown(c.image_inchannel)
            mc = c.motion_token_channel
            cc, oc = c.camera_motion_token_channel, c.object_motion_token_channel
            if c.use_regularizers:
                # the KL bottleneck halves the target streams' channels
                self.camera_target_motion_map = nn.Linear(cc // 2, mc)
                self.camera_source_motion_map = nn.Linear(cc, mc)
                self.object_target_motion_map = nn.Linear(oc // 2, mc)
                self.object_source_motion_map = nn.Linear(oc, mc)
            else:
                if cc != mc:
                    self.camera_motion_map = nn.Linear(cc, mc)
                if oc != mc:
                    self.object_motion_map = nn.Linear(oc, mc)
            if c.need_motion_transformer:
                self.motion_transformer = MotionSequenceTransformer(
                    motion_token_num=c.motion_token_num,
                    motion_token_channel=mc,
                    heads=c.motion_transformer_attn_num_heads,
                    head_dim=c.motion_transformer_attn_head_dim,
                    num_layers=c.motion_transformer_num_layers)
            dit_kw = dict(heads=c.diffusion_attn_num_heads,
                          head_dim=c.diffusion_attn_head_dim,
                          out_channels=c.diffusion_out_channels,
                          num_layers=c.diffusion_num_layers,
                          image_height=c.image_height,
                          image_width=c.image_width,
                          image_patch_size=c.image_patch_size,
                          image_in_channels=c.image_inchannel * 2,
                          motion_in_channels=mc, remat=c.remat,
                          remat_policy=c.remat_policy)
            if c.diffusion_model_type == "default":
                self.diffusion_transformer = VelocityDiT(
                    motion_type=c.motion_type, **dit_kw)
            elif c.diffusion_model_type == "dual":
                self.diffusion_transformer = VelocityDiTDualStream(
                    motion_target_num_frame=c.video_frames, **dit_kw)
            else:
                self.diffusion_transformer = VelocityDiTImgSpatial(
                    motion_type=c.motion_type,
                    motion_target_num_frame=c.video_frames, **dit_kw)
        self.to(device=dev, dtype=dtype)

    fsdp_forward_methods = ("encode", "encode_diff_motion", "velocity",
                            "extract_motion")

    def fsdp_units(self):
        """Every motion-encoder, motion-transformer and DiT block."""
        for name in ("camera_motion_encoder", "object_motion_encoder",
                     "motion_transformer", "diffusion_transformer"):
            mod = getattr(self, name, None)
            for blocks in ("transformer_blocks", "motion_blocks",
                           "spatial_blocks"):
                yield from getattr(mod, blocks, ())

    def encoder_sites(self, latents: torch.Tensor) -> Tuple[int, int]:
        """Patch tokens a frame of the object and of the camera encoder,
        for latents whose shape ends in (h, w)."""
        return (_sites(latents, self.cfg),
                camera_sites(latents.shape, self.cfg))

    def _encode_bands(self, hf, lf, mask_ratio, object_u, camera_u,
                      generator):
        lf = _frames_input(getattr(self, "camera_down", None), lf)
        return (self.object_motion_encoder(hf, mask_ratio, u=object_u,
                                           generator=generator),
                self.camera_motion_encoder(lf, mask_ratio, u=camera_u,
                                           generator=generator))

    def encode(self, video, ref_img, video_grey=None, ref_img_grey=None,
               mask_ratio: Optional[float] = None, camera_mask=None, *,
               object_u=None, camera_u=None, object_kl=None, camera_kl=None,
               generator=None) -> Dict[str, Optional[torch.Tensor]]:
        """-> dict of ``camera_source``, ``camera_target``,
        ``object_source``, ``object_target`` (N*T, L, D) and ``kl_loss``
        (None without ``use_regularizers``). Under ``use_filter`` the object
        encoder reads the high band (cutoff ``high_filter_num``) and the
        camera encoder the low band (``filter_num``; times ``camera_mask``
        under ``use_mask``) of cat(reference, video), grey under
        ``use_grey``. A float ``mask_ratio`` drops that share of both
        encoders' patch tokens (``object_u``/``camera_u`` (N*2T, patches)
        the uniform draws that order them); ``object_kl``/``camera_kl``
        are the KL posterior noises."""
        c = self.cfg
        n, t = video.shape[:2]
        refimg_and_video = torch.cat([ref_img, video], dim=1)
        if c.use_filter:
            src = (torch.cat([ref_img_grey, video_grey], dim=1)
                   if c.use_grey else refimg_and_video)
            lf, _ = _band_split(src, c.filter_num, c.filter_num)
            _, hf = _band_split(src, c.high_filter_num, c.high_filter_num)
            if c.use_mask and camera_mask is not None:
                lf = lf * camera_mask.to(lf)
        else:
            hf = lf = refimg_and_video
        motions = self._encode_bands(hf, lf, mask_ratio, object_u, camera_u,
                                     generator)
        return self._split_project(*motions, n, t, object_kl=object_kl,
                                   camera_kl=camera_kl, generator=generator)

    def encode_diff_motion(self, video, ref_img, video_grey, ref_img_grey,
                           camera_video_grey,
                           mask_ratio: Optional[float] = None, *,
                           object_u=None, camera_u=None, object_kl=None,
                           camera_kl=None, generator=None):
        """``encode`` with the camera band taken from another clip: the
        object encoder reads the high band of the subject (grey under
        ``use_grey``), the camera encoder the low band of cat(``ref_img``,
        ``camera_video_grey``) (the RGB reference, as the JAX package and
        the reference take it), both at the fixed cutoff 0.4."""
        c = self.cfg
        n, t = video.shape[:2]
        hf_src = (torch.cat([ref_img_grey, video_grey], dim=1)
                  if c.use_grey else torch.cat([ref_img, video], dim=1))
        lf_src = torch.cat([ref_img, camera_video_grey], dim=1)
        _, hf = _band_split(hf_src, 0.4, 0.4)
        lf, _ = _band_split(lf_src, 0.4, 0.4)
        motions = self._encode_bands(hf, lf, mask_ratio, object_u, camera_u,
                                     generator)
        return self._split_project(*motions, n, t, object_kl=object_kl,
                                   camera_kl=camera_kl, generator=generator)

    def _split_project(self, object_motion, camera_motion, n, t, *,
                       object_kl=None, camera_kl=None, generator=None):
        """The encoders' outputs split into source and target halves; under
        ``use_regularizers`` the targets pass the KL bottleneck (channels
        first around the regulariser; its posterior noises ``object_kl``
        and ``camera_kl``, else drawn from ``generator``, object first);
        each stream projected to the motion channel; the targets through
        the motion transformer with ``need_motion_transformer``."""
        c = self.cfg

        def flat(m):
            return m.reshape((n * t,) + m.shape[2:])

        object_source, object_target = (flat(object_motion[:, :t]),
                                        flat(object_motion[:, t:]))
        camera_source, camera_target = (flat(camera_motion[:, :t]),
                                        flat(camera_motion[:, t:]))
        kl_loss = None
        if c.use_regularizers:
            object_target, kl_o = diagonal_gaussian_regularize(
                object_target.transpose(1, 2), noise=object_kl,
                generator=generator)
            camera_target, kl_c = diagonal_gaussian_regularize(
                camera_target.transpose(1, 2), noise=camera_kl,
                generator=generator)
            object_target = object_target.transpose(1, 2)
            camera_target = camera_target.transpose(1, 2)
            kl_loss = (kl_o + kl_c) / 2
            camera_source = self.camera_source_motion_map(camera_source)
            camera_target = self.camera_target_motion_map(camera_target)
            object_source = self.object_source_motion_map(object_source)
            object_target = self.object_target_motion_map(object_target)
        else:
            if hasattr(self, "camera_motion_map"):
                camera_source = self.camera_motion_map(camera_source)
                camera_target = self.camera_motion_map(camera_target)
            if hasattr(self, "object_motion_map"):
                object_source = self.object_motion_map(object_source)
                object_target = self.object_motion_map(object_target)
        if c.need_motion_transformer:
            def transform(m):
                m = self.motion_transformer(m.reshape((n, t) + m.shape[1:]))
                return m.reshape((n * t,) + m.shape[2:])

            camera_target = transform(camera_target)
            object_target = transform(object_target)
        return dict(camera_source=camera_source, camera_target=camera_target,
                    object_source=object_source, object_target=object_target,
                    kl_loss=kl_loss)

    def kl_shapes(self, n: int, t: int) -> Tuple[Tuple[int, ...], ...]:
        """The shapes of the (object, camera) KL posterior noises of N
        clips of T frames: (N*T, D/2, L), channels first."""
        c = self.cfg
        return ((n * t, c.object_motion_token_channel // 2,
                 c.object_motion_token_num),
                (n * t, c.camera_motion_token_channel // 2,
                 c.camera_motion_token_num))

    def extract_motion(self, video, mask_ratio: Optional[float] = None, *,
                       u=None, generator=None):
        """Object-motion tokens (N, T, L, D) of ``video`` latents, as
        ``AMDModelNew.extract_motion``."""
        motion = self.object_motion_encoder(video, mask_ratio, u=u,
                                            generator=generator)
        if (self.cfg.need_motion_transformer and
                self.cfg.extract_motion_with_motion_transformer):
            motion = self.motion_transformer(motion)
        return motion

    def velocity(self, image_hidden_states, timestep, camera_source=None,
                 camera_target=None, object_source=None, object_target=None):
        if self.cfg.diffusion_model_type == "dual":
            return self.diffusion_transformer(
                sum_streams(camera_source, object_source),
                sum_streams(camera_target, object_target),
                image_hidden_states, timestep)
        return self.diffusion_transformer(
            camera_target, image_hidden_states, timestep,
            camera_motion_source=camera_source,
            object_motion_source=object_source,
            object_motion_target=object_target)

    def forward(self, video, ref_img, video_grey=None, ref_img_grey=None,
                mask_ratio: Optional[float] = None,
                return_meta_info: bool = False, camera_mask=None, *,
                draws: Optional[TrainDraws] = None,
                generator: Optional[torch.Generator] = None):
        """Training forward (JAX ``AMDModel.__call__``): motion encoding
        (the KL posterior noises first, object then camera), a
        rectified-flow train tuple at per-frame timesteps for the
        ``default`` DiT and per-clip ones otherwise, the velocity and the
        l2 losses; under ``use_regularizers`` ``loss`` adds
        ``klloss_weight`` times the KL, reported as ``KLloss``. A float
        ``mask_ratio`` drops encoder tokens (uniforms from ``generator``).
        Returns (pre, vel, loss_dict)."""
        c = self.cfg
        d = draws or TrainDraws()
        n, t = video.shape[:2]
        dev = video.device
        if c.use_mask and camera_mask is None:
            raise ValueError(
                "cfg.use_mask=True: the training forward requires the "
                "dataset's optical-flow camera_mask")
        motions = self.encode(video, ref_img, video_grey, ref_img_grey,
                              mask_ratio, camera_mask=camera_mask,
                              object_kl=d.object_kl, camera_kl=d.camera_kl,
                              generator=generator)
        kl_loss = motions.pop("kl_loss")
        zi = ref_img.reshape((n * t,) + ref_img.shape[2:])
        zj = video.reshape((n * t,) + video.shape[2:])
        time_step = d.time_step
        if time_step is None:
            time_step = draw_time_steps(c, n, t, generator, dev)
        time_step = time_step.to(dev)
        z0 = d.z0
        if z0 is None:
            z0 = torch.randn(zj.shape, generator=generator, dtype=zj.dtype,
                             device=dev)
        zt, vel = rf.get_train_tuple(zj, time_step, z0.to(zj),
                                     num_steps=c.scheduler_num_step)
        pre = self.velocity(torch.cat([zi, zt], dim=1), time_step.float(),
                            **motions)
        diff_loss = l2(pre, vel)
        rec_zj = rf.get_target_with_zt_vel(zt, pre, time_step,
                                           num_steps=c.scheduler_num_step)
        rec_loss = l2(rec_zj, zj)
        loss_dict = {"loss": diff_loss, "diff_loss": diff_loss,
                     "rec_loss": rec_loss}
        if c.use_regularizers:
            klloss = c.klloss_weight * kl_loss
            loss_dict.update(loss=diff_loss + klloss, KLloss=klloss)
        if return_meta_info:
            loss_dict.update(zi=zi, zj=zj, zt=zt, pre=pre, rec_zj=rec_zj,
                             time_step=time_step)
        return pre, vel, loss_dict


class AMDModelRec(nn.Module):
    """Timestep-free reconstruction model (JAX ``AMDModelRec``): two
    spatial motion encoders with ``need_norm_out`` over cat(reference,
    video), their source and target halves summed, a learnable
    ``zt_token`` in place of the noised target, and ``ReconstructionDiT``
    (``is_split``: its split form) regressing the target latents. Forward
    and loss only, as in the JAX package."""

    def __init__(self, cfg: AMDConfig, is_split: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = c = cfg
        self.is_split = is_split
        dev = resolve_device(device)
        enc_kw = dict(img_height=c.image_height, img_width=c.image_width,
                      img_inchannel=c.image_inchannel,
                      img_patch_size=c.image_patch_size,
                      motion_token_num=c.motion_token_num,
                      motion_channel=c.motion_token_channel,
                      need_norm_out=True, heads=c.enc_nhead,
                      head_dim=c.enc_ndim, num_layers=c.object_enc_num_layers)
        with torch.device(dev):
            self.object_motion_encoder = MotionEncoderSpatial(**enc_kw)
            self.camera_motion_encoder = MotionEncoderSpatial(**enc_kw)
            self.zt_token = nn.Parameter(0.02 * torch.randn(
                1, c.image_inchannel, c.image_height, c.image_width))
            self.transformer = ReconstructionDiT(
                heads=c.diffusion_attn_num_heads,
                head_dim=c.diffusion_attn_head_dim,
                out_channels=c.diffusion_out_channels,
                num_layers=c.diffusion_num_layers,
                image_height=c.image_height, image_width=c.image_width,
                image_patch_size=c.image_patch_size,
                image_in_channels=c.image_inchannel * 2,
                motion_in_channels=c.motion_token_channel, split=is_split)
        self.to(device=dev, dtype=dtype)

    def forward(self, video, ref_img):
        """-> (pre (N*T, C, H, W), {"loss", "rec_loss"})."""
        n, t = video.shape[:2]
        refimg_and_video = torch.cat([ref_img, video], dim=1)

        def flat(m):
            return m.reshape((n * t,) + m.shape[2:])

        obj = self.object_motion_encoder(refimg_and_video)
        cam = self.camera_motion_encoder(refimg_and_video)
        source = flat(obj[:, :t]) + flat(cam[:, :t])
        target = flat(obj[:, t:]) + flat(cam[:, t:])
        zi = ref_img.reshape((n * t,) + ref_img.shape[2:])
        zj = video.reshape((n * t,) + video.shape[2:])
        zt = self.zt_token.to(zj.dtype).expand(zj.shape)
        pre = self.transformer(source, target, torch.cat([zi, zt], dim=1))
        rec_loss = l2(pre, zj)
        return pre, {"loss": rec_loss, "rec_loss": rec_loss}


def draw_time_steps(cfg: AMDConfig, n: int, t: int,
                    generator: Optional[torch.Generator], device
                    ) -> torch.Tensor:
    """The training timesteps (N*T,) in [0, num_steps]: one per clip,
    repeated over its frames, or one per frame for the ``default`` DiT."""
    hi = cfg.scheduler_num_step + 1
    if cfg.diffusion_model_type == "default":
        return torch.randint(0, hi, (n * t,), generator=generator,
                             device=device)
    steps = torch.randint(0, hi, (n,), generator=generator, device=device)
    return steps.repeat_interleave(t)


def camera_sites(shape: Sequence[int], cfg: AMDConfig) -> int:
    """Camera-encoder sites of a latent frame whose shape ends in (h, w)
    (on the 4x smaller grid under ``use_camera_down``)."""
    down = 4 if cfg.use_camera_down else 1
    p = cfg.image_patch_size
    return (shape[-2] // down // p) * (shape[-1] // down // p)


Device = Optional[Union[str, torch.device]]
# the fixed widths of the JAX package's factories
_S_WIDTHS = dict(enc_nhead=8, enc_ndim=64, diffusion_attn_head_dim=64,
                 diffusion_attn_num_heads=16, diffusion_out_channels=4,
                 diffusion_num_layers=12)
_L_WIDTHS = dict(enc_nhead=16, enc_ndim=64, diffusion_attn_head_dim=96,
                 diffusion_attn_num_heads=16, diffusion_out_channels=4,
                 diffusion_num_layers=16)


def AMD_N(device: Device = None, dtype: torch.dtype = torch.float32,
          **kw) -> AMDModelNew:
    """AMD_N factory with the JAX package's fixed widths."""
    return AMDModelNew(AMDConfig(**_S_WIDTHS, **kw), device=device,
                       dtype=dtype)


def AMD_S(device: Device = None, dtype: torch.dtype = torch.float32,
          **kw) -> AMDModel:
    """The dual-encoder AMDModel at AMD_N's widths."""
    return AMDModel(AMDConfig(**_S_WIDTHS, **kw), device=device, dtype=dtype)


def AMD_L(device: Device = None, dtype: torch.dtype = torch.float32,
          **kw) -> AMDModel:
    """The dual-encoder AMDModel with 16 encoder heads and a 16-layer DiT
    of 16 heads of 96."""
    return AMDModel(AMDConfig(**_L_WIDTHS, **kw), device=device, dtype=dtype)


def AMD_S_Camera(device: Device = None, dtype: torch.dtype = torch.float32,
                 **kw) -> AMDModelNew:
    """The camera-only variant: ``AMDModelNew`` with the object stream
    off."""
    kw.setdefault("use_object", False)
    kw.setdefault("use_camera", True)
    return AMDModelNew(AMDConfig(**_S_WIDTHS, **kw), device=device,
                       dtype=dtype)


def AMD_S_Rec(device: Device = None, dtype: torch.dtype = torch.float32,
              **kw) -> AMDModelRec:
    return AMDModelRec(AMDConfig(**_S_WIDTHS, **kw), device=device,
                       dtype=dtype)


def AMD_S_RecSplit(device: Device = None, dtype: torch.dtype = torch.float32,
                   **kw) -> AMDModelRec:
    return AMDModelRec(AMDConfig(**_S_WIDTHS, **kw), is_split=True,
                       device=device, dtype=dtype)


AMD_MODELS = {
    "AMD_S": AMD_S,
    "AMD_S_Camera": AMD_S_Camera,
    "AMD_N": AMD_N,
    "AMD_L": AMD_L,
    "AMD_S_Rec": AMD_S_Rec,
    "AMD_S_RecSplit": AMD_S_RecSplit,
}

# the class each factory of AMD_MODELS builds, for a model whose config
# comes from a config.json rather than from the factory's fixed widths
AMD_CLASSES = {
    "AMD_S": AMDModel,
    "AMD_S_Camera": AMDModelNew,
    "AMD_N": AMDModelNew,
    "AMD_L": AMDModel,
    "AMD_S_Rec": AMDModelRec,
    "AMD_S_RecSplit": functools.partial(AMDModelRec, is_split=True),
}


def _euler_decode(model: AMDModelNew, zi, z0, motions, sample_step: int,
                  start_step: int, z1=None, solver: str = "euler",
                  quant_table=None):
    """ODE-walk the DiT from ``start_step`` down to step 0 with ``solver``
    ("euler", or "heun": two velocity calls a step). Below the full range
    the walk starts from the partially noised target ``z1``. With a
    ``quant_table`` (``ops.quant.quantize_params`` of the model) the
    velocity calls run the table's layers in int8."""
    solvers = {"euler": rf.euler_sample, "heun": rf.heun_sample}
    if solver not in solvers:
        raise ValueError(f"unknown solver {solver!r}; use 'euler' or 'heun'")
    num_steps = model.cfg.scheduler_num_step
    step_seq = rf.sample_step_sequence(sample_step, start_step, num_steps)
    z_start = rf.euler_start(z0, z1, start_step, num_steps)

    def vel_fn(zt, tstep):
        return model.velocity(torch.cat([zi, zt], dim=1), tstep, **motions)

    with quant_ops.maybe_quantized(model, quant_table):
        return solvers[solver](vel_fn, z_start, step_seq)


def _sites(latents: torch.Tensor, cfg: AMDConfig) -> int:
    """Patch tokens of one (.., C, h, w) latent frame."""
    p = cfg.image_patch_size
    return (latents.shape[-2] // p) * (latents.shape[-1] // p)


def _static(ratio) -> Optional[float]:
    return None if ratio is None else float(ratio)


def _unflat(x: torch.Tensor, n: int, t: int) -> torch.Tensor:
    return x.reshape((n, t) + x.shape[1:])


def _dual_draws(model: "AMDModel", draws: SampleDraws, video,
                mask_ratio: Optional[float]) -> Dict[str, torch.Tensor]:
    """The encode draws of the dual-encoder model for ``video`` (N, T, ..)
    latents, in the JAX package's order: with a ``mask_ratio`` the object
    and the camera encoder's uniforms (N*2T, patches), then under
    ``use_regularizers`` the object and camera KL posterior noises."""
    n, t = video.shape[:2]
    out = {}
    if mask_ratio is not None:
        so, sc = model.encoder_sites(video)
        out["object_u"] = draws.uniform((n * 2 * t, so), video.device)
        out["camera_u"] = draws.uniform((n * 2 * t, sc), video.device)
    if model.cfg.use_regularizers:
        for name, shape in zip(("object_kl", "camera_kl"),
                               model.kl_shapes(n, t)):
            out[name] = draws.normal(shape, video.dtype, video.device)
    return out


@no_grad
def sample(model: AMDModelNew, video, ref_img, video_grey=None,
           ref_img_grey=None, sample_step: int = 50,
           start_step: Optional[int] = None,
           camera_mask_ratio: Optional[float] = None,
           object_mask_ratio: Optional[float] = None, camera_mask=None,
           solver: str = "euler", generator: DrawSource = None,
           quant_table=None):
    """Reconstruction: motion from ``video`` (N,T,C,H,W latents), then an
    ODE decode from noise. The mask ratios (floats) drop that share of each
    encoder's tokens. ``camera_mask`` (N,2T,C,h,w), the optical-flow camera
    mask, is read by a ``use_mask`` model and refused by any other (the JAX
    package ignores it there). Draws come from ``generator`` (a
    ``torch.Generator`` or ``SampleDraws``): the camera and object mask
    uniforms, then the start noise (N*T,C,H,W). ``quant_table`` runs the
    ODE loop's velocity calls in int8; the motion encoding stays in the
    compute dtype. Returns (zi, sample, zj), each (N,T,C,H,W).

    The dual-encoder ``AMDModel`` takes one ratio, ``camera_mask_ratio``,
    for both encoders, and ignores ``object_mask_ratio`` and
    ``camera_mask``, as the JAX package does; its draws are the object and
    camera mask uniforms (N*2T, patches), then, under
    ``use_regularizers``, the KL posterior noises (object, camera: the
    posterior sample, not its mode), then the start noise."""
    cfg = model.cfg
    draws = sample_draws(generator)
    n, t = video.shape[:2]
    start = cfg.scheduler_num_step if start_step is None else start_step
    camera_mask_ratio = _static(camera_mask_ratio)
    object_mask_ratio = _static(object_mask_ratio)
    dev = video.device
    if isinstance(model, AMDModel):
        motions = model.encode(
            video, ref_img, video_grey, ref_img_grey, camera_mask_ratio,
            **_dual_draws(model, draws, video, camera_mask_ratio))
        motions.pop("kl_loss")
    else:
        if camera_mask is not None and not cfg.use_mask:
            raise NotImplementedError(
                "camera_mask is read only by a use_mask model; this model "
                "has use_mask=False")
        camera_u = object_u = None
        if camera_mask_ratio is not None and cfg.use_camera:
            camera_u = draws.uniform((n, camera_sites(video.shape, cfg)),
                                     dev)
        if object_mask_ratio is not None and cfg.use_object:
            object_u = draws.uniform((n * 2 * t, _sites(video, cfg)), dev)
        camera_target, object_source, object_target = model.encode(
            video, ref_img, video_grey, ref_img_grey, camera_mask_ratio,
            object_mask_ratio, camera_mask=camera_mask, camera_u=camera_u,
            object_u=object_u)
        motions = dict(camera_target=camera_target,
                       object_source=object_source,
                       object_target=object_target)
    zi = ref_img.reshape((n * t,) + ref_img.shape[2:])
    zj = video.reshape((n * t,) + video.shape[2:])
    noise = draws.normal(zj.shape, zj.dtype, zj.device)
    zt = _euler_decode(model, zi, noise, motions, sample_step, start,
                       z1=zj, solver=solver, quant_table=quant_table)
    return _unflat(zi, n, t), _unflat(zt, n, t), _unflat(zj, n, t)


@torch.no_grad()
def decode(model: AMDModelNew, ref_img, motions: Dict[str, torch.Tensor],
           frames: int, sample_step: int = 50,
           start_step: Optional[int] = None, video=None,
           solver: str = "euler", generator: DrawSource = None,
           quant_table=None) -> torch.Tensor:
    """Video latents (N, frames, C, H, W) from a reference frame and motion
    tokens (``motions``: the ``velocity`` keywords). A single reference
    frame (N, 1, C, H, W) is tiled to ``frames``; a clip must already have
    ``frames``. ``video``, the target latents, seeds the walk when
    ``start_step`` is below the scheduler's range."""
    n, t = ref_img.shape[:2]
    if t == 1 and frames > 1:
        ref_img = ref_img.expand((n, frames) + ref_img.shape[2:])
        t = frames
    if t != frames:
        raise ValueError(f"decode: ref_img carries {t} frames but "
                         f"frames={frames}; pass a single frame (tiled here) "
                         "or a matching clip")
    start = model.cfg.scheduler_num_step if start_step is None else start_step
    zi = ref_img.reshape((n * t,) + ref_img.shape[2:])
    z1 = None if video is None else video.reshape((n * t,) + video.shape[2:])
    z0 = sample_draws(generator).normal(zi.shape, zi.dtype, zi.device)
    zt = _euler_decode(model, zi, z0, motions, sample_step, start, z1=z1,
                       solver=solver, quant_table=quant_table)
    return _unflat(zt, n, t)


@torch.no_grad()
def sample_with_refimg_motion(model: AMDModelNew, ref_img, motion,
                              sample_step: int = 10, solver: str = "euler",
                              mask_ratio: Optional[float] = None,
                              generator: DrawSource = None,
                              quant_table=None):
    """Image + motion tokens -> video latents: the source motion extracted
    from the reference frame ``ref_img`` (N, C, H, W), the given ``motion``
    (N, F, L, D) as the target, both in the object stream; with
    ``need_motion_transformer`` the target runs through the motion
    transformer unless ``extract_motion`` already applies it (to the
    source). ``mask_ratio`` masks the source extraction; its uniform is
    drawn (before the start noise) only then. Returns (zi, sample), each
    (N, F, C, H, W).

    On the dual-encoder ``AMDModel`` the tokens ride as the camera stream,
    the object stream empty; its ``use_motiontemporal`` encoder reads a
    (reference, reference) pair and the source is the pair's second
    half (the mask uniform is then (2N, patches))."""
    cfg = model.cfg
    n, t, l, d = motion.shape
    draws = sample_draws(generator)
    dual = isinstance(model, AMDModel)
    enc_in = ref_img[:, None]
    if dual and cfg.use_motiontemporal:
        enc_in = torch.cat([enc_in, enc_in], dim=1)
    u = None
    if mask_ratio is not None:
        u = draws.uniform((n * enc_in.shape[1], _sites(ref_img, cfg)),
                          ref_img.device)
    src = model.extract_motion(enc_in, mask_ratio, u=u)[:, -1:]
    if (cfg.need_motion_transformer and
            not cfg.extract_motion_with_motion_transformer):
        motion = model.motion_transformer(motion)
    source = src.expand(n, t, l, d).reshape(n * t, l, d)
    target = motion.reshape(n * t, l, d)
    motions = (dict(camera_source=source, camera_target=target) if dual
               else dict(object_source=source, object_target=target))
    zi = ref_img[:, None].expand((n, t) + ref_img.shape[1:]).reshape(
        (n * t,) + ref_img.shape[1:])
    z0 = draws.normal(zi.shape, zi.dtype, zi.device)
    zt = _euler_decode(model, zi, z0, motions, sample_step,
                       model.cfg.scheduler_num_step, solver=solver,
                       quant_table=quant_table)
    return _unflat(zi, n, t), _unflat(zt, n, t)


@torch.no_grad()
def sample_cross(model: AMDModelNew, video_1, video_2, ref_img,
                 video_grey_1=None, sample_step: int = 50,
                 start_step: Optional[int] = None,
                 camera_mask_ratio: Optional[float] = None,
                 solver: str = "euler", generator: DrawSource = None,
                 quant_table=None):
    """Cross-video motion transfer: camera motion from the low band (cutoff
    0.5) of ``video_1`` (its grey clip under ``use_grey``; through
    ``CameraDown`` under ``use_camera_down``), appearance from
    ``ref_img``; only the camera stream drives the DiT, and ``video_2``
    seeds the walk below the full range. The JAX package's
    ``video_grey_2``, ``ref_img_grey`` and ``object_mask_ratio`` are
    accepted there and read by nothing, so they are not taken here.
    Returns (zi, sample, zj), each (N, T, C, H, W)."""
    cfg = model.cfg
    draws = sample_draws(generator)
    n, t = video_1.shape[:2]
    start = cfg.scheduler_num_step if start_step is None else start_step
    lf_video, _ = _band_split(video_grey_1 if cfg.use_grey else video_1,
                              0.5, 0.5)
    camera_mask_ratio = _static(camera_mask_ratio)
    u = None
    if camera_mask_ratio is not None:
        u = draws.uniform((n, camera_sites(video_1.shape, cfg)),
                          video_1.device)
    camera_target = model.camera_motion_encoder(
        model.camera_input(lf_video), camera_mask_ratio, u=u)
    zi = ref_img.reshape((n * t,) + ref_img.shape[2:])
    zj = video_2.reshape((n * t,) + video_2.shape[2:])
    z0 = draws.normal(zj.shape, zj.dtype, zj.device)
    zt = _euler_decode(model, zi, z0, dict(camera_target=camera_target),
                       sample_step, start, z1=zj, solver=solver,
                       quant_table=quant_table)
    return _unflat(zi, n, t), _unflat(zt, n, t), _unflat(zj, n, t)


@torch.no_grad()
def sample_diff_motion(model: AMDModel, video, ref_img, video_grey=None,
                       ref_img_grey=None, camera_video_grey=None,
                       sample_step: int = 50,
                       start_step: Optional[int] = None,
                       mask_ratio: Optional[float] = None,
                       solver: str = "euler", generator: DrawSource = None,
                       quant_table=None):
    """Reconstruct ``video`` (N,T,C,H,W latents) with the camera stream's
    motion taken from another clip, ``camera_video_grey``
    (``AMDModel.encode_diff_motion``; the dual-encoder model only). Draws
    as ``sample``'s for that model. Returns (zi, sample, zj), each
    (N,T,C,H,W)."""
    if not isinstance(model, AMDModel):
        raise TypeError("sample_diff_motion needs the dual-encoder AMDModel "
                        f"(AMD_S or AMD_L), not {type(model).__name__}")
    cfg = model.cfg
    draws = sample_draws(generator)
    n, t = video.shape[:2]
    start = cfg.scheduler_num_step if start_step is None else start_step
    mask_ratio = _static(mask_ratio)
    motions = model.encode_diff_motion(
        video, ref_img, video_grey, ref_img_grey, camera_video_grey,
        mask_ratio, **_dual_draws(model, draws, video, mask_ratio))
    motions.pop("kl_loss")
    zi = ref_img.reshape((n * t,) + ref_img.shape[2:])
    zj = video.reshape((n * t,) + video.shape[2:])
    z0 = draws.normal(zj.shape, zj.dtype, zj.device)
    zt = _euler_decode(model, zi, z0, motions, sample_step, start, z1=zj,
                       solver=solver, quant_table=quant_table)
    return _unflat(zi, n, t), _unflat(zt, n, t), _unflat(zj, n, t)


@torch.no_grad()
def extract_motion(model: AMDModelNew, video,
                   mask_ratio: Optional[float] = None,
                   generator: DrawSource = None) -> torch.Tensor:
    """Frozen-model object-motion extraction (N, T, L, D); a ``mask_ratio``
    needs ``generator`` (or ``SampleDraws``) for its token draw."""
    u = None
    if mask_ratio is not None:
        if generator is None:
            raise ValueError("extract_motion(mask_ratio=...) needs "
                             "generator=")
        n, t = video.shape[:2]
        u = sample_draws(generator).uniform(
            (n * t, _sites(video, model.cfg)), video.device)
    return model.extract_motion(video, mask_ratio, u=u)
