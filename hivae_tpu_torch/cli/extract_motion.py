"""Offline object-motion extraction with the port: for every mp4 under
``--video_dir``, ``--video_frames`` frames sampled at 8 fps are
VAE-encoded and their motion tokens extracted ``--chunk_frames`` frames at
a time, saved as float32 ``<name>_motion.npy`` (1, F, L, D): the model's
bf16 values widened, exactly, so that numpy reads them without
``ml_dtypes`` (the counterpart of the JAX package's ``extract_motion.py``,
which saves the bf16 array itself).

    python -m hivae_tpu_torch.cli.extract_motion --amd_config config.json \
        --amd_ckpt out/checkpoints --video_dir videos --output_dir motion

A video that fails is reported and skipped; the exit code is 1 when any
did.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

import numpy as np
import torch

from ..data import video as vio
from ..models import amd as amd_mod
from ..models import vae as vae_mod
from ..utils.device import resolve_device
from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_model_args(p)
    p.add_argument("--video_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="motion_out")
    p.add_argument("--chunk_frames", type=int, default=16,
                   help="frames per extraction call")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = common.load_amd(args, device)
    vae = common.build_vae(args, device)
    size = common.sample_size(model, vae)
    os.makedirs(args.output_dir, exist_ok=True)
    failed = 0
    for vp in common.mp4s(args.video_dir):
        try:
            total, fps = vio.video_metadata(vp)
            idx = vio.sample_frames_with_fps(total, fps, args.video_frames,
                                             8, start_index=0)
            pixels = vio.pixel_transform(vio.read_video_frames(vp, idx), size)
            z = vae_mod.vae_encode(vae, torch.from_numpy(pixels).to(
                device)[None])
            chunks = [amd_mod.extract_motion(model, z[:, s:s +
                                                      args.chunk_frames])
                      for s in range(0, z.shape[1], args.chunk_frames)]
            motion = torch.cat(chunks, dim=1).float().cpu().numpy()
            name = os.path.splitext(os.path.basename(vp))[0]
            np.save(os.path.join(args.output_dir, f"{name}_motion.npy"),
                    motion)
            print(f"{vp}: motion {motion.shape}")
        except Exception as e:  # report, and go on with the next video
            failed += 1
            traceback.print_exc()
            print(f"FAILED {vp}: {e}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
