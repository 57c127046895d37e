"""Optical-flow camera/object region masks on the host (the port's own
copy of ``hivae_tpu/data/flow_mask.py``).

Farneback flow between the first and the last frame of a clip; each small
window is set against the mean direction of its big window (direction
spread and variance rules), the masks are closed morphologically, the white
camera windows are cut at random to the ``mask_video_ratio`` budget, and the
masks are sampled down to a 32x32 grid. OpenCV is imported inside the
function, as in ``data/video.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

DIRECTION_THRESHOLD = np.pi / 6


def flow_mask(frame1: np.ndarray, frame2: np.ndarray,
              l_window_size: int = 128, s_window_size: int = 32,
              direction_var_threshold: float = 6,
              direction_threshold: float = 0.4,
              mask_video_ratio: float = 0.5,
              rng: Optional[np.random.RandomState] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """RGB uint8 frames (H, W, 3) -> (camera_mask, object_mask), each
    (32, 32) float64 in {0, 1}; ``rng`` orders the budget's cut."""
    import cv2

    rng = rng or np.random
    frame1 = cv2.resize(frame1, (256, 256), interpolation=cv2.INTER_LINEAR)
    frame2 = cv2.resize(frame2, (256, 256), interpolation=cv2.INTER_LINEAR)
    gray1 = cv2.cvtColor(cv2.cvtColor(frame1, cv2.COLOR_RGB2BGR),
                         cv2.COLOR_BGR2GRAY)
    gray2 = cv2.cvtColor(cv2.cvtColor(frame2, cv2.COLOR_RGB2BGR),
                         cv2.COLOR_BGR2GRAY)
    gray1 = cv2.GaussianBlur(gray1, (5, 5), 0)
    gray2 = cv2.GaussianBlur(gray2, (5, 5), 0)

    flow = cv2.calcOpticalFlowFarneback(
        gray1, gray2, None, pyr_scale=0.5, levels=3, winsize=30,
        iterations=3, poly_n=7, poly_sigma=1.5,
        flags=cv2.OPTFLOW_FARNEBACK_GAUSSIAN)
    u, v = flow[..., 0], flow[..., 1]
    direction = np.arctan2(v, u)
    height, width = u.shape

    # the mean direction of each big window
    big = np.zeros((height // l_window_size + 1, width // l_window_size + 1))
    for y in range(0, height, l_window_size):
        for x in range(0, width, l_window_size):
            wu = u[y:y + l_window_size, x:x + l_window_size]
            wv = v[y:y + l_window_size, x:x + l_window_size]
            big[y // l_window_size, x // l_window_size] = np.arctan2(
                np.mean(wv), np.mean(wu))

    cam = np.full((height, width), 255, np.uint8)
    obj = np.full((height, width), 255, np.uint8)
    for y in range(0, height, s_window_size):
        for x in range(0, width, s_window_size):
            win = (slice(y, y + s_window_size), slice(x, x + s_window_size))
            base = big[y // l_window_size, x // l_window_size]
            wd = direction[win]
            diff = np.abs(wd - base)
            diff = np.minimum(diff, 2 * np.pi - diff)
            if np.mean(diff > DIRECTION_THRESHOLD) > direction_threshold:
                cam[win] = 0
            else:
                obj[win] = 0
            var = np.var(wd)
            if var > direction_var_threshold:
                cam[win] = 0
            else:
                obj[win] = 0
            if var < 0.2:
                cam[win] = 255

    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
    cam = cv2.morphologyEx(cam, cv2.MORPH_CLOSE, kernel)
    obj = cv2.morphologyEx(obj, cv2.MORPH_CLOSE, kernel)

    # cut the white camera windows to the mask_video_ratio budget
    white = [(y, x) for y in range(0, height, s_window_size)
             for x in range(0, width, s_window_size)
             if np.all(cam[y:y + s_window_size, x:x + s_window_size] == 255)]
    max_white = int((height / s_window_size) ** 2 * (1 - mask_video_ratio))
    if len(white) > max_white:
        order = list(white)
        rng.shuffle(order)
        for y, x in order[max_white:]:
            cam[y:y + s_window_size, x:x + s_window_size] = 0

    cam = cam.astype(np.float64) / 255
    obj = obj.astype(np.float64) / 255
    step = cam.shape[0] // 32
    return cam[::step, ::step], obj[::step, ::step]
