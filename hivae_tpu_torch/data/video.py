"""Host-side video decode, pixel transforms and mp4 writing (the port's own
copy of ``hivae_tpu/data/video.py``).

The reference decodes with decord and transforms with torchvision
(Resize(256, antialias) -> CenterCrop(256) -> Normalize(0.5, 0.5)).
Decoding uses OpenCV, and the resize calls
``torch.nn.functional.interpolate`` with ``antialias=True``, the kernel
torchvision's Resize dispatches to, so transformed frames match the
reference bit for bit.

OpenCV is imported inside the functions that decode, convert or encode, so
that this module, and the pipelines' device work on tensors, run where
OpenCV is missing. Everything here runs on the host; outputs are numpy
arrays handed to the device.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def sample_frames_with_fps(total_frames: int, video_fps: float,
                           sample_num_frames: int, sample_fps: float,
                           start_index: Optional[int] = None,
                           rng: Optional[random.Random] = None) -> np.ndarray:
    """fps-proportional frame indices (the reference dataset's rule)."""
    interval = round(video_fps / sample_fps)
    frames_range = (sample_num_frames - 1) * interval + 1
    if start_index is not None:
        start = start_index
    elif total_frames - frames_range - 1 < 0:
        start = 0
    else:
        start = (rng or random).randint(0, total_frames - frames_range - 1)
    return np.linspace(start, min(total_frames - 1, start + frames_range),
                       num=sample_num_frames).astype(int)


def read_video_frames(path: str, indices: np.ndarray) -> np.ndarray:
    """Decode specific frames -> (F, H, W, 3) uint8 RGB."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    frames = []
    want = set(int(i) for i in indices)
    max_idx = int(max(want))
    by_idx = {}
    idx = 0
    while idx <= max_idx:
        ok, frame = cap.read()
        if not ok:
            break
        if idx in want:
            by_idx[idx] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        idx += 1
    cap.release()
    if not by_idx:
        raise IOError(f"no frames decoded from {path}")
    last = by_idx[max(by_idx)]
    return np.stack([by_idx.get(int(i), last) for i in indices])


def video_metadata(path: str) -> Tuple[int, float]:
    """(frame count, frames per second) of the video at ``path``."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    cap.release()
    return n, fps


def to_grayscale(frames: np.ndarray) -> np.ndarray:
    """RGB (F,H,W,3) uint8 -> 3-channel grayscale, matching the reference's
    cv2 RGB->BGR->GRAY chain."""
    import cv2

    out = np.zeros(frames.shape[:3], dtype=np.uint8)
    for i in range(frames.shape[0]):
        bgr = cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR)
        out[i] = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    return np.repeat(out[:, None], 3, axis=1).transpose(0, 2, 3, 1)


def pixel_transform(frames: np.ndarray, size: int = 256) -> np.ndarray:
    """uint8 (F,H,W,C) -> float32 (F,C,size,size) in [-1, 1]:
    Resize(size, bilinear+antialias) -> CenterCrop(size) -> Normalize(.5,.5).
    """
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).float()
    x /= 255.0  # in-place: one 13 MB/clip allocation instead of three
    f, c, h, w = x.shape
    # torchvision Resize semantics: scale shorter side to `size`; the
    # long side TRUNCATES (torchvision _compute_resized_output_size uses
    # int(), not round()) — a 1-pixel difference shifts every antialiased
    # sample and the center crop, breaking bit parity
    if h < w:
        nh, nw = size, max(1, int(w * size / h))
    else:
        nh, nw = max(1, int(h * size / w)), size
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear",
                          antialias=True, align_corners=False)
    # center crop
    top = max(0, (x.shape[2] - size) // 2)
    left = max(0, (x.shape[3] - size) // 2)
    x = x[:, :, top:top + size, left:left + size]
    if x.shape[2] < size or x.shape[3] < size:
        ph, pw = size - x.shape[2], size - x.shape[3]
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    x = x.contiguous()
    x -= 0.5
    x /= 0.5
    return x.numpy()


def save_videos_grid(path: str, videos: np.ndarray, fps: float = 8.0,
                     n_cols: int = 4) -> None:
    """Tile a batch of videos (N, F, C, H, W) uint8 into one grid mp4
    (the reference's ``save_videos_grid``)."""
    n, f, c, h, w = videos.shape
    n_cols = min(n_cols, n)
    n_rows = -(-n // n_cols)
    grid = np.zeros((f, n_rows * h, n_cols * w, c), dtype=np.uint8)
    for i in range(n):
        r, col = divmod(i, n_cols)
        grid[:, r * h:(r + 1) * h, col * w:(col + 1) * w] = \
            videos[i].transpose(0, 2, 3, 1)
    write_video(path, grid, fps=fps)


def to_hwc_frames(frames: np.ndarray) -> np.ndarray:
    """(F,C,H,W) or (F,H,W,C) -> (F,H,W,C): the single layout heuristic
    shared by every writer (channels-first iff dim 1 looks like 1/3
    channels and is smaller than the trailing dim)."""
    if frames.ndim != 4:
        raise ValueError("frames must be (F, H, W, C) or (F, C, H, W)")
    if frames.shape[1] in (1, 3) and frames.shape[1] < frames.shape[-1]:
        frames = frames.transpose(0, 2, 3, 1)
    return frames


def write_video(path: str, frames: np.ndarray, fps: float = 8.0,
                audio_path: Optional[str] = None,
                audio_start: float = 0.0) -> str:
    """(F,C,H,W) or (F,H,W,C) uint8 -> mp4 via OpenCV. With
    ``audio_path`` the [audio_start, audio_start + F / fps) seconds of that
    wav are muxed in (``data/av_mux.py``: an mp4 through ffmpeg where the
    binary is on PATH, else an AVI, so the extension may change). Returns
    the path written."""
    if audio_path is not None:
        from .av_mux import export_video_with_audio

        return export_video_with_audio(path, frames, fps, audio_path,
                                       audio_start)
    import cv2

    frames = to_hwc_frames(frames)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             float(fps), (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open writer for {path}")
    try:
        for f in frames:
            writer.write(cv2.cvtColor(np.ascontiguousarray(f),
                                      cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
    return path
