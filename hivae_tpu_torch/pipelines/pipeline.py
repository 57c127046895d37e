"""Inference pipelines (port of ``hivae_tpu/pipelines/pipeline.py``): clip
reconstruction, windowed long-video reconstruction, cross-video motion
transfer, the diff-motion reconstruction (camera motion from another clip;
the dual-encoder ``AMDModel`` only), the GT-motion ablation and
audio-to-video generation (``ImageAudio2VideoPipeline``: a reference image
and per-frame audio embeddings, W-frame windows of A2M motion sampling and
AMD decoding chained autoregressively).

Each pipeline has two entries per path. The file entry (``sample``,
``sample_long``, ``sample_cross``, ``sample_diff``, ``reconstruct``) reads
an mp4 on the host (``data/video.py``, OpenCV), runs the device half and
writes an mp4 when given a path. The device half (``sample_pixels``,
``sample_long_pixels``, ``sample_cross_pixels``, ``sample_diff_pixels``,
``reconstruct_pixels``) takes (F+1, 3, H, W) pixels in [-1, 1], frame 0 the
reference, and returns the uint8 clip on the models' device: SD-VAE
encode, AMD motion extraction and ODE decode, SD-VAE decode. The models
are ``AMDModelNew`` or ``AMDModel`` (the reconstruction, long-video and
GT-motion paths take either; the dual-encoder model reads one mask ratio,
the camera one). ``quant="int8"`` serves the ODE loop's DiT and the VAE
decode in w8a8 (``ops/quant.py``), and the A2M head's ODE loop where it
has layers the int8 predicate takes.

Randomness comes from ``generator``: a ``torch.Generator`` on the models'
device, or ``models.amd.SampleDraws`` to replay draws made elsewhere. A
path takes its draws window by window in the order ``models.amd`` documents.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..data import video as vio
from ..models import a2m as a2m_mod
from ..models import amd as amd_mod
from ..models import vae as vae_mod
from ..ops import quant as quant_ops
from ..utils.misc import no_grad

# Each table covers exactly the modules its quantised leg runs: the DiT for
# the ODE loop, the decoder for the decode leg (the encode stays in the
# compute dtype, so stripping the decoder's weights leaves it whole), the
# A2M head's denoiser for its ODE loop (its audio encoder runs once a
# window, outside the loop).
QUANT_SCOPES = {"dit": ("diffusion_transformer",), "vae": ("decoder",),
                "a2m": ("diffusion",)}


def build_quant_table(quant: Optional[str], model, scope: str,
                      allow_empty: bool = False):
    """``quant="int8"``: the int8 table of ``model``'s layers under
    ``QUANT_SCOPES[scope]`` (``ops.quant.quantize_params``), else None.
    With ``allow_empty`` a model none of whose layers the size predicate
    takes (a small A2M head) serves in its compute dtype, with a warning,
    instead of raising."""
    if quant is None:
        return None
    if quant != "int8":
        raise ValueError(f"unknown quant mode {quant!r}; use 'int8' or None")
    try:
        return quant_ops.quantize_params(model, scope=QUANT_SCOPES[scope])
    except ValueError as e:
        if allow_empty and "matched no kernels" in str(e):
            warnings.warn(
                f"quant: no {scope} layers clear the int8 size predicate; "
                "that leg serves in the compute dtype", stacklevel=2)
            return None
        raise


def _dtype(amd) -> torch.dtype:
    return amd.diffusion_transformer.proj_out.weight.dtype


def _encode(vae: vae_mod.AutoencoderKL, amd: amd_mod.AMDModelNew,
            pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F+1, 3, H, W) pixels -> (reference (1, 1, C, h, w), targets
    (1, F, C, h, w)) latents in the DiT's dtype."""
    z = vae_mod.vae_encode(vae, pixels[None]).to(_dtype(amd))
    return z[:, :1], z[:, 1:]


def _grey_needed(amd, grey):
    if amd.cfg.use_grey and grey is None:
        raise ValueError("the model uses grey frames: pass grey=")


@no_grad
def reconstruct_clip(vae: vae_mod.AutoencoderKL, amd: amd_mod.AMDModelNew,
                     pixels: torch.Tensor, grey: Optional[torch.Tensor] = None,
                     generator: amd_mod.DrawSource = None,
                     sample_step: int = 20, *,
                     camera_mask_ratio: Optional[float] = None,
                     object_mask_ratio: Optional[float] = None,
                     solver: str = "euler", quant_table=None,
                     vae_quant_table=None) -> torch.Tensor:
    """(F+1, 3, H, W) pixels in [-1, 1] (frame 0 is the reference) ->
    reconstructed (F+1, 3, H, W) uint8. ``grey`` is the grey clip, needed
    when the model's config has ``use_grey``. The mask uniforms and the
    start noise (F, C, h, w) come from ``generator``. ``quant_table`` /
    ``vae_quant_table`` (``ops.quant.quantize_params`` of ``amd`` and
    ``vae``) run the ODE loop and the decode in int8."""
    _grey_needed(amd, grey)
    ref, gt = _encode(vae, amd, pixels)
    grey_kw = {}
    if amd.cfg.use_grey:
        gref, ggt = _encode(vae, amd, grey)
        grey_kw = dict(video_grey=ggt, ref_img_grey=gref.expand(gt.shape))
    _, video_pre, _ = amd_mod.sample(
        amd, gt, ref.expand(gt.shape), sample_step=sample_step,
        camera_mask_ratio=camera_mask_ratio,
        object_mask_ratio=object_mask_ratio, solver=solver,
        generator=generator, quant_table=quant_table, **grey_kw)
    result = torch.cat([ref, video_pre], dim=1)
    return vae_mod.vae_decode_rgb(vae, result, quant_table=vae_quant_table)[0]


@torch.no_grad()
def cross_clip(vae: vae_mod.AutoencoderKL, amd: amd_mod.AMDModelNew,
               pix1: torch.Tensor, pix2: torch.Tensor,
               grey1: Optional[torch.Tensor] = None,
               generator: amd_mod.DrawSource = None, sample_step: int = 20,
               *, quant_table=None, vae_quant_table=None) -> torch.Tensor:
    """Motion transfer: the camera motion of clip 1 (its grey clip
    ``grey1`` under ``use_grey``), the appearance of clip 2's frame 0 ->
    (F+1, 3, H, W) uint8. Clip 1 is encoded once (grey or RGB, whichever
    drives the camera stream), clip 2 once (its reference frame and the
    targets that seed a partial walk)."""
    _grey_needed(amd, grey1)
    _, cam = _encode(vae, amd, grey1 if amd.cfg.use_grey else pix1)
    ref2, gt2 = _encode(vae, amd, pix2)
    _, video_pre, _ = amd_mod.sample_cross(
        amd, cam, gt2, ref2.expand(gt2.shape), video_grey_1=cam,
        sample_step=sample_step, generator=generator,
        quant_table=quant_table)
    result = torch.cat([ref2, video_pre], dim=1)
    return vae_mod.vae_decode_rgb(vae, result, quant_table=vae_quant_table)[0]


@torch.no_grad()
def diff_motion_clip(vae: vae_mod.AutoencoderKL, amd: amd_mod.AMDModel,
                     pixels: torch.Tensor, grey: Optional[torch.Tensor],
                     camera_pixels: torch.Tensor,
                     generator: amd_mod.DrawSource = None,
                     sample_step: int = 20, *, quant_table=None,
                     vae_quant_table=None) -> torch.Tensor:
    """Reconstruction of ``pixels`` (F+1, 3, H, W) with the camera stream's
    motion taken from ``camera_pixels`` (the camera clip's grey frames for a
    ``use_grey`` model) -> (F+1, 3, H, W) uint8. Encodes: the subject, its
    grey clip (``use_grey``), the camera clip; one decode."""
    _grey_needed(amd, grey)
    ref, gt = _encode(vae, amd, pixels)
    gref, ggt = _encode(vae, amd, grey) if amd.cfg.use_grey else (ref, gt)
    _, cam = _encode(vae, amd, camera_pixels)
    _, video_pre, _ = amd_mod.sample_diff_motion(
        amd, gt, ref.expand(gt.shape), video_grey=ggt,
        ref_img_grey=gref.expand(gt.shape), camera_video_grey=cam,
        sample_step=sample_step, generator=generator,
        quant_table=quant_table)
    result = torch.cat([ref, video_pre], dim=1)
    return vae_mod.vae_decode_rgb(vae, result, quant_table=vae_quant_table)[0]


@torch.no_grad()
def long_recon_window(amd: amd_mod.AMDModelNew, cur_gt, prev_img,
                      grey_cur_gt=None, grey_prev_img=None, *,
                      sample_step: int, mask_ratio: Optional[float] = None,
                      drop_prev_img: bool = False, solver: str = "euler",
                      generator: amd_mod.DrawSource = None,
                      quant_table=None) -> torch.Tensor:
    """One W-frame window of the long-video reconstruction: the targets
    ``cur_gt`` (N, W, C, h, w) reconstructed from ``prev_img`` (N, C, h, w)
    as the reference frame (zeroed by ``drop_prev_img``); ``mask_ratio``
    masks both motion encoders (the dual-encoder model's one ratio).
    Returns the window's latents."""
    ref = prev_img[:, None].expand(cur_gt.shape)
    if drop_prev_img:
        ref = torch.zeros_like(ref)
    kw = {}
    if amd.cfg.use_grey:
        kw = dict(video_grey=grey_cur_gt,
                  ref_img_grey=grey_prev_img[:, None].expand(cur_gt.shape))
    return amd_mod.sample(
        amd, cur_gt, ref, sample_step=sample_step,
        camera_mask_ratio=mask_ratio, object_mask_ratio=mask_ratio,
        solver=solver, generator=generator, quant_table=quant_table,
        **kw)[1]


@torch.no_grad()
def gt_motion_window(amd: amd_mod.AMDModelNew, cur_gt, m2v_ref, *,
                     sample_step: int, mask_ratio: Optional[float] = None,
                     generator: amd_mod.DrawSource = None,
                     quant_table=None) -> torch.Tensor:
    """One GT-motion ablation window: object motion extracted from the
    targets ``cur_gt`` (N, W, C, h, w) (masked by ``mask_ratio``), decoded
    from the reference frame ``m2v_ref`` (N, C, h, w). The mask uniforms
    are drawn only when masking."""
    draws = amd_mod.sample_draws(generator)
    u = None
    if mask_ratio is not None:
        n, t = cur_gt.shape[:2]
        u = draws.uniform((n * t, amd_mod._sites(cur_gt, amd.cfg)),
                          cur_gt.device)
    motion = amd.extract_motion(cur_gt, mask_ratio, u=u)
    return amd_mod.sample_with_refimg_motion(
        amd, m2v_ref, motion, sample_step=sample_step,
        mask_ratio=mask_ratio, generator=draws, quant_table=quant_table)[1]


@torch.no_grad()
def a2v_window(amd: amd_mod.AMDModelNew, a2m, ref_motion, audio,
               ref_audio, m2v_ref, *, motion_steps: int, video_steps: int,
               generator: amd_mod.DrawSource = None, quant_table=None,
               a2m_quant_table=None):
    """One audio-to-video window: the A2M head samples the window's motion
    tokens from ``audio`` (N, W, M, D), conditioned on the last reference
    frame's tokens and audio (``ref_motion`` (N, R, L, D), ``ref_audio``
    (N, R, M, D)); the AMD model decodes them from the reference latent
    ``m2v_ref`` (N, C, h, w). Draws: the A2M start noise, then the AMD
    one. Returns (motion (N, W, L, D), video latents (N, W, C, h, w))."""
    draws = amd_mod.sample_draws(generator)
    motion_pre = a2m_mod.sample(
        a2m, ref_motion[:, -1], frames=audio.shape[1],
        sample_step=motion_steps, audio=audio, ref_audio=ref_audio[:, -1],
        generator=draws, quant_table=a2m_quant_table)
    _, video_pre = amd_mod.sample_with_refimg_motion(
        amd, m2v_ref, motion_pre, sample_step=video_steps, generator=draws,
        quant_table=quant_table)
    return motion_pre, video_pre


class _Serving:
    """The models, their device and the int8 tables. ``quant="int8"``
    quantises the DiT's and the VAE decoder's large layers
    (``ops.quant.quantize_params`` with ``QUANT_SCOPES``) and strips their
    float weights from ``amd`` and ``vae`` in place, so the serving models
    hold int8 and scales where the tables cover them."""

    def __init__(self, vae: vae_mod.AutoencoderKL, amd: amd_mod.AMDModelNew,
                 window: int = 16, sample_size: int = 256,
                 quant: Optional[str] = None):
        self.vae, self.amd, self.window = vae, amd, window
        self.sample_size = sample_size
        self.device = amd.diffusion_transformer.proj_out.weight.device
        self.quant_table = build_quant_table(quant, amd, "dit")
        self.vae_quant_table = build_quant_table(quant, vae, "vae")
        for model, table in ((amd, self.quant_table),
                             (vae, self.vae_quant_table)):
            if table:
                quant_ops.strip_quantized(model, table)

    def _tensor(self, x) -> Optional[torch.Tensor]:
        return None if x is None else torch.as_tensor(x).to(self.device)

    def _pixels(self, frames: np.ndarray):
        """uint8 (F, H, W, 3) frames -> pixels and, for a grey model, grey
        pixels (F, 3, size, size) in [-1, 1]."""
        pixels = vio.pixel_transform(frames, self.sample_size)
        grey = None
        if self.amd.cfg.use_grey:
            grey = vio.pixel_transform(vio.to_grayscale(frames),
                                       self.sample_size)
        return pixels, grey

    def _load_clip(self, video_path: str, fps: int):
        """window+1 frames of ``video_path`` sampled at ``fps`` ->
        (pixels, grey or None)."""
        total, video_fps = vio.video_metadata(video_path)
        idx = vio.sample_frames_with_fps(total, video_fps, self.window + 1,
                                         fps, start_index=0)
        return self._pixels(vio.read_video_frames(video_path, idx))

    @staticmethod
    def _finish(out: torch.Tensor, output_path: Optional[str],
                fps: float) -> np.ndarray:
        out = out.cpu().numpy()
        if output_path:
            vio.write_video(output_path, out, fps=fps)
        return out


class AMDReconstructionPipeline(_Serving):
    """Single-window and windowed long-video reconstruction through the
    motion bottleneck. Whether grey frames are read follows the model's
    ``use_grey``."""

    def sample(self, video_path: str, output_path: Optional[str] = None,
               video_sample_step: int = 20, fps: int = 8,
               object_mask_ratio: Optional[float] = None,
               camera_mask_ratio: Optional[float] = None,
               generator: amd_mod.DrawSource = None,
               solver: str = "euler") -> np.ndarray:
        """window+1 frames of the video sampled at ``fps`` -> the
        reconstructed clip (F+1, 3, H, W) uint8, written as an mp4 when
        ``output_path`` is given. ``solver="heun"`` takes two DiT calls a
        step."""
        pixels, grey = self._load_clip(video_path, fps)
        out = self.sample_pixels(
            pixels, grey, video_sample_step, generator=generator,
            camera_mask_ratio=camera_mask_ratio,
            object_mask_ratio=object_mask_ratio, solver=solver)
        return self._finish(out, output_path, fps)

    def sample_pixels(self, pixels, grey=None, video_sample_step: int = 20,
                      generator: amd_mod.DrawSource = None, *,
                      camera_mask_ratio: Optional[float] = None,
                      object_mask_ratio: Optional[float] = None,
                      solver: str = "euler") -> torch.Tensor:
        """The device half of ``sample``: (window+1, 3, H, W) pixels in
        [-1, 1] (and grey pixels for a grey model) -> the reconstructed clip
        as uint8 of the same shape on the models' device."""
        if pixels.shape[0] != self.window + 1:
            raise ValueError(f"expected {self.window + 1} frames (reference "
                             f"+ window), got {pixels.shape[0]}")
        return reconstruct_clip(
            self.vae, self.amd, self._tensor(pixels), self._tensor(grey),
            generator, video_sample_step,
            camera_mask_ratio=camera_mask_ratio,
            object_mask_ratio=object_mask_ratio, solver=solver,
            quant_table=self.quant_table,
            vae_quant_table=self.vae_quant_table)

    def sample_long(self, video_path: str, output_path: Optional[str] = None,
                    video_sample_step: int = 4,
                    mask_ratio: Optional[float] = None, fps: int = 30,
                    drop_prev_img: bool = False, max_frames: int = 256,
                    generator: amd_mod.DrawSource = None,
                    solver: str = "euler") -> np.ndarray:
        """Windowed autoregressive long-video reconstruction of up to
        ``max_frames`` + 1 consecutive frames (no fps resampling; ``fps``
        is the written file's); see ``sample_long_pixels``."""
        total, _ = vio.video_metadata(video_path)
        frames = vio.read_video_frames(video_path,
                                       np.arange(min(total, max_frames + 1)))
        pixels, grey = self._pixels(frames)
        out = self.sample_long_pixels(
            pixels, grey, video_sample_step, mask_ratio=mask_ratio,
            drop_prev_img=drop_prev_img, generator=generator, solver=solver)
        return self._finish(out, output_path, fps)

    def sample_long_pixels(self, pixels, grey=None,
                           video_sample_step: int = 4,
                           mask_ratio: Optional[float] = None,
                           drop_prev_img: bool = False,
                           generator: amd_mod.DrawSource = None,
                           solver: str = "euler") -> torch.Tensor:
        """The device half of ``sample_long``: (F+1, 3, H, W) consecutive
        pixels -> (F+1, 3, H, W) uint8. The clip is VAE-encoded once and
        decoded once; in between, W = ``window`` target frames at a time
        are reconstructed, each window's reference frame the previous
        window's last generated latent (window 0: frame 0's).

        As in the JAX package: ``mask_ratio`` masks both motion encoders,
        ``0.0`` meaning off; ``drop_prev_img`` zeroes the reference; a
        ragged tail re-runs the last W frames and its overlap replaces the
        earlier predictions, so the output has as many frames as the input;
        under ``use_grey`` window 0's grey reference is the grey frame 0
        and later windows' the grey target frame before the window."""
        mask_ratio = mask_ratio or None
        w = self.window
        pixels, grey = self._tensor(pixels), self._tensor(grey)
        _grey_needed(self.amd, grey)
        ref_z, gt_z = _encode(self.vae, self.amd, pixels)
        grey_ref = grey_gt = None
        if self.amd.cfg.use_grey:
            grey_ref, grey_gt = _encode(self.vae, self.amd, grey)
        t = gt_z.shape[1]
        if t < w:
            raise ValueError(
                f"sample_long needs at least window+1={w + 1} frames; the "
                f"clip has {t + 1} (use sample() for single short clips)")
        draws = amd_mod.sample_draws(generator)

        def window(s, e, prev):
            grey_prev = None
            if grey_gt is not None:
                grey_prev = grey_ref[:, 0] if s == 0 else grey_gt[:, s - 1]
            return long_recon_window(
                self.amd, gt_z[:, s:e], prev,
                None if grey_gt is None else grey_gt[:, s:e], grey_prev,
                sample_step=video_sample_step, mask_ratio=mask_ratio,
                drop_prev_img=drop_prev_img, solver=solver, generator=draws,
                quant_table=self.quant_table)

        pre = None
        for s in range(0, t - t % w, w):
            prev = ref_z[:, 0] if pre is None else pre[:, -1]
            win = window(s, s + w, prev)
            pre = win if pre is None else torch.cat([pre, win], dim=1)
        if t % w:
            s = t - w
            win = window(s, t, pre[:, -1])
            pre = torch.cat([pre[:, :s], win], dim=1)
        result = torch.cat([ref_z, pre], dim=1)
        return vae_mod.vae_decode_rgb(self.vae, result,
                                      quant_table=self.vae_quant_table)[0]


class AMDCrossVideoPipeline(AMDReconstructionPipeline):
    """Motion from ``video_path_1``, appearance from ``video_path_2``."""

    def sample_cross(self, video_path_1: str, video_path_2: str,
                     output_path: Optional[str] = None,
                     video_sample_step: int = 20, fps: int = 8,
                     generator: amd_mod.DrawSource = None) -> np.ndarray:
        pix1, grey1 = self._load_clip(video_path_1, fps)
        pix2, _ = self._load_clip(video_path_2, fps)
        out = self.sample_cross_pixels(pix1, pix2, grey1, video_sample_step,
                                       generator)
        return self._finish(out, output_path, fps)

    def sample_cross_pixels(self, pix1, pix2, grey1=None,
                            video_sample_step: int = 20,
                            generator: amd_mod.DrawSource = None
                            ) -> torch.Tensor:
        """The device half of ``sample_cross`` (``cross_clip``)."""
        return cross_clip(self.vae, self.amd, self._tensor(pix1),
                          self._tensor(pix2), self._tensor(grey1), generator,
                          video_sample_step, quant_table=self.quant_table,
                          vae_quant_table=self.vae_quant_table)


class AMDDiffMotionPipeline(AMDReconstructionPipeline):
    """Reconstruct ``video_path`` with the camera stream's motion taken from
    ``camera_video_path`` (``models.amd.sample_diff_motion``; the
    dual-encoder ``AMDModel`` only)."""

    def __init__(self, vae, amd, *args, **kw):
        if not isinstance(amd, amd_mod.AMDModel):
            raise TypeError("AMDDiffMotionPipeline needs the dual-encoder "
                            "AMDModel (AMD_S or AMD_L), not "
                            f"{type(amd).__name__}")
        super().__init__(vae, amd, *args, **kw)

    def sample_diff(self, video_path: str, camera_video_path: str,
                    output_path: Optional[str] = None,
                    video_sample_step: int = 20, fps: int = 8,
                    generator: amd_mod.DrawSource = None) -> np.ndarray:
        """window+1 frames of each video sampled at ``fps``; the camera
        clip's grey frames drive a ``use_grey`` model's camera stream, its
        RGB frames any other's."""
        pixels, grey = self._load_clip(video_path, fps)
        cam_pixels, cam_grey = self._load_clip(camera_video_path, fps)
        out = self.sample_diff_pixels(
            pixels, grey, cam_pixels if cam_grey is None else cam_grey,
            video_sample_step, generator)
        return self._finish(out, output_path, fps)

    def sample_diff_pixels(self, pixels, grey, camera_pixels,
                           video_sample_step: int = 20,
                           generator: amd_mod.DrawSource = None
                           ) -> torch.Tensor:
        """The device half of ``sample_diff`` (``diff_motion_clip``)."""
        return diff_motion_clip(
            self.vae, self.amd, self._tensor(pixels), self._tensor(grey),
            self._tensor(camera_pixels), generator, video_sample_step,
            quant_table=self.quant_table,
            vae_quant_table=self.vae_quant_table)


class GTMotionAblationPipeline(_Serving):
    """Windowed GT-motion reconstruction ablation: object-motion tokens
    extracted from each W-frame window of the clip (optionally masked) and
    decoded chained on the previous window's last generated frame, which
    isolates the decoder from a motion generator."""

    def reconstruct(self, video_path: str, output_path: Optional[str] = None,
                    num_windows: int = 2, video_sample_step: int = 10,
                    fps: int = 8, generator: amd_mod.DrawSource = None,
                    mask_ratio: Optional[float] = None) -> np.ndarray:
        """``num_windows`` * W + 1 frames of the video sampled at ``fps``;
        ``mask_ratio`` is the share of motion tokens dropped at
        extraction."""
        total, video_fps = vio.video_metadata(video_path)
        idx = vio.sample_frames_with_fps(total, video_fps,
                                         num_windows * self.window + 1, fps,
                                         start_index=0)
        pixels = vio.pixel_transform(vio.read_video_frames(video_path, idx),
                                     self.sample_size)
        out = self.reconstruct_pixels(pixels, num_windows, video_sample_step,
                                      generator, mask_ratio)
        return self._finish(out, output_path, fps)

    def reconstruct_pixels(self, pixels, num_windows: int = 2,
                           video_sample_step: int = 10,
                           generator: amd_mod.DrawSource = None,
                           mask_ratio: Optional[float] = None
                           ) -> torch.Tensor:
        """The device half of ``reconstruct``: (num_windows * W + 1, 3, H,
        W) pixels -> uint8 of the same shape; one VAE encode and one decode
        of the whole clip."""
        w = self.window
        if pixels.shape[0] != num_windows * w + 1:
            raise ValueError(f"expected {num_windows * w + 1} frames, got "
                             f"{pixels.shape[0]}")
        ref_z, gt_z = _encode(self.vae, self.amd, self._tensor(pixels))
        draws = amd_mod.sample_draws(generator)
        pre = None
        for i in range(num_windows):
            m2v_ref = ref_z[:, 0] if pre is None else pre[:, -1]
            win = gt_motion_window(
                self.amd, gt_z[:, i * w:(i + 1) * w], m2v_ref,
                sample_step=video_sample_step, mask_ratio=mask_ratio,
                generator=draws, quant_table=self.quant_table)
            pre = win if pre is None else torch.cat([pre, win], dim=1)
        result = torch.cat([ref_z, pre], dim=1)
        return vae_mod.vae_decode_rgb(self.vae, result,
                                      quant_table=self.vae_quant_table)[0]


class ImageAudio2VideoPipeline(_Serving):
    """Windowed autoregressive audio-driven video generation: each W-frame
    window's reference is the previous window's last R motion tokens (or,
    with ``need_motion_extract_model``, tokens re-extracted from its last R
    generated latents) and R audio frames; the A2M head samples the
    window's motion and the AMD model decodes it from the last generated
    latent. A ragged tail re-runs the last W frames of the audio and its
    overlap replaces the earlier windows' frames. The head is any A2M head
    that samples from audio alone (``models.a2m.sample``: the audio
    cross-attention head, LearnableToken, SimpleAdaLN); it is handed the
    window's audio and the reference frame's, never pose.

    ``quant="int8"`` serves three legs in w8a8 and strips their float
    weights: the AMD DiT's ODE loop, the VAE decode and the A2M head's ODE
    loop (``allow_empty``: a head too small for the int8 predicate serves
    in its compute dtype). Motion extraction, the audio encoding and the
    VAE encode stay in the compute dtype."""

    def __init__(self, vae: vae_mod.AutoencoderKL, amd: amd_mod.AMDModelNew,
                 a2m, window: int = 16, a2m_ref_num_frame: int = 8,
                 sample_size: int = 256,
                 need_motion_extract_model: bool = False,
                 quant: Optional[str] = None):
        if window < a2m_ref_num_frame:
            raise ValueError(f"window {window} < a2m_ref_num_frame "
                             f"{a2m_ref_num_frame}")
        super().__init__(vae, amd, window, sample_size, quant)
        self.a2m = a2m
        self.ref_frames = a2m_ref_num_frame
        self.need_motion_extract_model = need_motion_extract_model
        self.a2m_quant_table = build_quant_table(quant, a2m, "a2m",
                                                 allow_empty=True)
        if self.a2m_quant_table:
            quant_ops.strip_quantized(a2m, self.a2m_quant_table)

    def _pad_ref(self, x: torch.Tensor) -> torch.Tensor:
        """The last R frames of ``x`` (N, F, ...), left-padded with zero
        frames to R."""
        r = self.ref_frames
        if x.shape[1] >= r:
            return x[:, -r:]
        pad = x.new_zeros((x.shape[0], r - x.shape[1]) + x.shape[2:])
        return torch.cat([pad, x], dim=1)

    def _extract(self, latents: torch.Tensor) -> torch.Tensor:
        return amd_mod.extract_motion(self.amd, latents)

    @torch.no_grad()
    def predict(self, ref_img, ref_audio, audio,
                motion_sample_step: int = 4, video_sample_step: int = 4,
                generator: amd_mod.DrawSource = None) -> torch.Tensor:
        """ref_img (N, F0, 3, H, W) pixels in [-1, 1], ref_audio (N, F0, M,
        D), audio (N, T, M, D) -> video latents (N, T+1, C, h, w), the
        reference frame's first. Each window draws the A2M start noise,
        then the AMD one (``a2v_window``)."""
        w, r = self.window, self.ref_frames
        ref_img, ref_audio, audio = (self._tensor(x) for x in (
            ref_img, ref_audio, audio))
        total = audio.shape[1]
        if total < w:
            raise ValueError(f"the audio has {total} frames; a window needs "
                             f"{w}")
        draws = amd_mod.sample_draws(generator)
        ref_z = vae_mod.vae_encode(self.vae, self._pad_ref(ref_img)).to(
            _dtype(self.amd))

        def window(ref_motion, s, e, cur_ref_audio, m2v_ref):
            return a2v_window(
                self.amd, self.a2m, ref_motion, audio[:, s:e], cur_ref_audio,
                m2v_ref, motion_steps=motion_sample_step,
                video_steps=video_sample_step, generator=draws,
                quant_table=self.quant_table,
                a2m_quant_table=self.a2m_quant_table)

        pre_motion = pre_video = None
        for s in range(0, total - total % w, w):
            if s == 0:
                ref_motion = self._extract(ref_z)
                cur_ref_audio = self._pad_ref(ref_audio)
                m2v_ref = ref_z[:, -1]
            else:
                ref_motion = (self._extract(pre_video[:, -r:])
                              if self.need_motion_extract_model
                              else pre_motion[:, -r:])
                cur_ref_audio = audio[:, s - r:s]
                m2v_ref = pre_video[:, -1]
            motion_pre, video_pre = window(ref_motion, s, s + w,
                                           cur_ref_audio, m2v_ref)
            pre_motion = motion_pre if pre_motion is None else torch.cat(
                [pre_motion, motion_pre], dim=1)
            pre_video = video_pre if pre_video is None else torch.cat(
                [pre_video, video_pre], dim=1)
        if total % w:
            s = total - w
            ref_motion = (self._extract(pre_video[:, s - r:s])
                          if self.need_motion_extract_model
                          else pre_motion[:, s - r:s])
            motion_pre, video_pre = window(ref_motion, s, total,
                                           audio[:, s - r:s],
                                           pre_video[:, s - 1])
            pre_motion = torch.cat([pre_motion[:, :s], motion_pre], dim=1)
            pre_video = torch.cat([pre_video[:, :s], video_pre], dim=1)
        return torch.cat([ref_z[:, -1:], pre_video], dim=1)

    def sample_pixels(self, pixels, audio_emb, motion_sample_step: int = 8,
                      video_sample_step: int = 20,
                      generator: amd_mod.DrawSource = None,
                      max_frames: Optional[int] = None) -> torch.Tensor:
        """The device half of ``sample``: the reference frame's pixels (3,
        H, W) in [-1, 1] and the embeddings (T+1, M, D), the first the
        reference frame's (at most ``max_frames`` of them) -> the video
        (T+1, 3, H, W) uint8 on the models' device, the reference frame's
        reconstruction first."""
        emb = self._tensor(audio_emb)[None]
        if max_frames is not None:
            emb = emb[:, :max_frames]
        latents = self.predict(self._tensor(pixels)[None, None], emb[:, :1],
                               emb[:, 1:], motion_sample_step,
                               video_sample_step, generator=generator)
        return vae_mod.vae_decode_rgb(self.vae, latents,
                                      quant_table=self.vae_quant_table)[0]

    def sample(self, refimg_path: str, audio_emb: np.ndarray,
               output_path: Optional[str] = None,
               motion_sample_step: int = 8, video_sample_step: int = 20,
               fps: int = 25, generator: amd_mod.DrawSource = None,
               max_frames: Optional[int] = None,
               audio_path: Optional[str] = None) -> np.ndarray:
        """A reference image file and whisper embeddings (T+1, M, D) -> the
        generated video (T+1, 3, H, W) uint8, written to ``output_path``
        when given, with ``audio_path``'s wav muxed in (without ffmpeg the
        file is an AVI: call ``data.video.write_video`` on the result for
        the path written). ``max_frames`` caps the embeddings used."""
        import cv2

        frame = cv2.cvtColor(cv2.imread(refimg_path), cv2.COLOR_BGR2RGB)
        pixels = vio.pixel_transform(frame[None], self.sample_size)[0]
        out = self.sample_pixels(pixels, audio_emb, motion_sample_step,
                                 video_sample_step, generator, max_frames)
        out = out.cpu().numpy()
        if output_path:
            vio.write_video(output_path, out, fps=fps, audio_path=audio_path)
        return out
