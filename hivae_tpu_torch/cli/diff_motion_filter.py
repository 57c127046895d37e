"""Optical-flow camera/object mask tuning visualiser (the counterpart of
the JAX package's ``diff_motion_filter.py``, with its flags): sweep the
flow-mask thresholds (``data/flow_mask.py``) over one clip and write each
mask as a green overlay on the first frame. It runs on the host (OpenCV);
no model and no card is involved.

    python -m hivae_tpu_torch.cli.diff_motion_filter --video_path clip.mp4 \
        [--s_window_sizes 16 32 64] [--direction_thresholds 0.3 0.4 0.5] \
        [--two_sample | --video_path_2 other.mp4] [--output_dir flow_masks]

Two-sample mode (``--two_sample`` or ``--video_path_2``) also computes the
camera mask over a second frame interval ([frames_apart, 2 frames_apart]
of the same clip, or the first interval of the second clip) and keeps the
windows white in both (``two_sample_mask``), at most
``--max_white_windows`` of them. The random cuts of the white-window
budgets draw from numpy's global generator, as the JAX CLI's do.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import video as vio
from ..data.flow_mask import flow_mask


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="flow_masks")
    p.add_argument("--frames_apart", type=int, default=15)
    p.add_argument("--s_window_sizes", type=int, nargs="+",
                   default=[16, 32, 64])
    p.add_argument("--direction_thresholds", type=float, nargs="+",
                   default=[0.3, 0.4, 0.5])
    p.add_argument("--mask_video_ratio", type=float, default=0.5)
    p.add_argument("--two_sample", action="store_true",
                   help="compare masks across two frame intervals")
    p.add_argument("--video_path_2", type=str, default=None,
                   help="second clip for two-sample mode (defaults to "
                        "--video_path with a shifted interval)")
    p.add_argument("--max_white_windows", type=int, default=32,
                   help="two-sample white-window budget")
    return p.parse_args(argv)


def two_sample_mask(cam1: np.ndarray, cam2: np.ndarray,
                    s_window_size: int = 32, max_white: int = 32,
                    rng=None) -> np.ndarray:
    """The windows of ``s_window_size`` (in mask cells) that are equal in
    the two (H, W) {0, 1} camera masks and hold a white cell, white; past
    ``max_white`` such windows, a random choice of the extra ones (the
    order of ``rng``, numpy's global generator by default) is cleared."""
    rng = rng or np.random
    h, w = cam1.shape
    out = np.zeros_like(cam1)
    white = []
    for y in range(0, h, s_window_size):
        for x in range(0, w, s_window_size):
            w1 = cam1[y:y + s_window_size, x:x + s_window_size]
            w2 = cam2[y:y + s_window_size, x:x + s_window_size]
            if np.array_equal(w1, w2) and np.any(w1 == 1):
                out[y:y + s_window_size, x:x + s_window_size] = 1
                white.append((y, x))
    if len(white) > max_white:
        for i in rng.permutation(len(white))[max_white:]:
            y, x = white[i]
            out[y:y + s_window_size, x:x + s_window_size] = 0
    return out


def _pair(path: str, start: int, end: int):
    frames = vio.read_video_frames(path, np.array([start, end]))
    return frames[0], frames[1]


def main(argv=None):
    import cv2

    args = parse_args(argv)
    total, _ = vio.video_metadata(args.video_path)
    last = min(args.frames_apart, total - 1)
    f1, f2 = _pair(args.video_path, 0, last)
    two_sample = args.two_sample or args.video_path_2 is not None
    if two_sample:
        if args.video_path_2:
            t2, _ = vio.video_metadata(args.video_path_2)
            g1, g2 = _pair(args.video_path_2, 0,
                           min(args.frames_apart, t2 - 1))
        else:
            g1, g2 = _pair(args.video_path, last,
                           min(2 * args.frames_apart, total - 1))
    os.makedirs(args.output_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(args.video_path))[0]
    base = cv2.resize(f1, (256, 256))
    written = []
    for sw in args.s_window_sizes:
        for dt in args.direction_thresholds:
            cam, obj = flow_mask(f1, f2, s_window_size=sw,
                                 direction_threshold=dt,
                                 mask_video_ratio=args.mask_video_ratio)
            pairs = [("camera", cam), ("object", obj)]
            if two_sample:
                cam2, _ = flow_mask(g1, g2, s_window_size=sw,
                                    direction_threshold=dt,
                                    mask_video_ratio=args.mask_video_ratio)
                # the masks are 32 x 32: a window of sw pixels is sw // 8
                pairs.append(("camera_two_sample", two_sample_mask(
                    cam, cam2, max(1, sw // 8), args.max_white_windows)))
            for tag, mask in pairs:
                m = cv2.resize((mask * 255).astype(np.uint8), (256, 256),
                               interpolation=cv2.INTER_NEAREST)
                overlay = base.copy()
                overlay[..., 1] = np.maximum(overlay[..., 1], m)
                out = os.path.join(args.output_dir,
                                   f"{name}_sw{sw}_dt{dt}_{tag}.png")
                cv2.imwrite(out, cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
                print("saved:", out)
                written.append(out)
    return written


if __name__ == "__main__":
    main()
