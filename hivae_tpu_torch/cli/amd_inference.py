"""Batch video reconstruction with the port: build the AMD model from a
``config.json`` and its checkpoint, then reconstruct every mp4 under
``--video_dir`` into ``--output_dir/<name>_recon.mp4`` (the counterpart of
the JAX package's ``amd_inference.py``, with the same flags and
``--device``).

    python -m hivae_tpu_torch.cli.amd_inference --amd_config config.json \
        --amd_ckpt out/checkpoints --video_dir videos [--long] [--device cpu]

A video that fails is reported and skipped; the exit code is 1 when any
did. The config's ``attn_impl`` is installed for every attention call; with
``ring``, launch one process a card (``torchrun`` or ``HIVAE_MULTIHOST=1``,
``--dist_backend`` for the process group): the ring spans every rank and
rank 0 writes the mp4s. The ranks sample each video together, so under a
launch a video that fails ends the run instead of being skipped: the rank
exits with the error, and its peers' next collective fails (``torchrun``
ends them at once).
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

import torch.distributed as dist

from ..pipelines import AMDReconstructionPipeline
from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_model_args(p)
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=[None, "nccl", "gloo"],
                   help="process group backend of a multi-rank launch "
                        "(torchrun or HIVAE_MULTIHOST=1): nccl on CUDA and "
                        "gloo on the CPU by default")
    p.add_argument("--video_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--sample_step", type=int, default=10)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--solver", type=str, default="euler",
                   choices=["euler", "heun"],
                   help="ODE integrator; heun takes two DiT calls a step")
    p.add_argument("--use_ema", action="store_true",
                   help="load the EMA weights of a trainer checkpoint "
                        "(falls back to the live params without one)")
    p.add_argument("--long", action="store_true",
                   help="windowed autoregressive long-video mode: chain "
                        "each window on the previous window's last "
                        "generated frame, up to --max_frames")
    p.add_argument("--max_frames", type=int, default=256,
                   help="long mode: frame cap")
    p.add_argument("--mask_ratio", type=float, default=None,
                   help="long mode: motion-token mask ratio")
    p.add_argument("--drop_prev_img", action="store_true",
                   help="long mode: zero the chained reference frame")
    p.add_argument("--quant", type=str, default=None, choices=["int8"],
                   help="int8: run the DiT's ODE loop and the VAE decode "
                        "in w8a8")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = common.start(args)
    try:
        return run(args, device)
    finally:
        common.finish()


def run(args, device) -> int:
    model = common.load_amd(args, device)
    vae = common.build_vae(args, device)
    pipe = AMDReconstructionPipeline(
        vae, model, window=args.video_frames,
        sample_size=common.sample_size(model, vae), quant=args.quant)

    os.makedirs(args.output_dir, exist_ok=True)
    videos = common.mp4s(args.video_dir)
    launched = dist.is_initialized() and dist.get_world_size() > 1
    failed = 0
    for i, vp in enumerate(videos):
        name = os.path.splitext(os.path.basename(vp))[0]
        out = os.path.join(args.output_dir, f"{name}_recon.mp4") \
            if common.writes_files() else None
        gen = common.draws(device, i)
        try:
            if args.long:
                pipe.sample_long(vp, out, video_sample_step=args.sample_step,
                                 fps=args.fps, generator=gen,
                                 solver=args.solver,
                                 max_frames=args.max_frames,
                                 mask_ratio=args.mask_ratio,
                                 drop_prev_img=args.drop_prev_img)
            else:
                pipe.sample(vp, out, video_sample_step=args.sample_step,
                            fps=args.fps, generator=gen, solver=args.solver)
            print(f"[{i + 1}/{len(videos)}] {vp} -> {out}")
        except Exception as e:
            if launched:   # the peers wait in this video's collectives
                raise
            failed += 1    # report, and go on with the next video
            traceback.print_exc()
            print(f"[{i + 1}/{len(videos)}] FAILED {vp}: {e}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
