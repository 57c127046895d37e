"""Cross-video motion transfer with the port: the camera motion of
``--video_path_1`` applied to the appearance of ``--video_path_2``, written
to ``--output_path`` (the counterpart of the JAX package's
``amd_inference_single.py``). With ``--diff_motion`` (the dual-encoder
``AMDModel``, ``--model_type AMD_S`` or ``AMD_L``) video 2 is
reconstructed with the camera motion of video 1
(``AMDDiffMotionPipeline``).

    python -m hivae_tpu_torch.cli.amd_inference_single \
        --amd_config config.json --amd_ckpt out/checkpoints \
        --video_path_1 motion.mp4 --video_path_2 appearance.mp4
"""

from __future__ import annotations

import argparse
import sys

from ..models.amd import AMDModel
from ..pipelines import AMDCrossVideoPipeline, AMDDiffMotionPipeline
from ..utils.device import resolve_device
from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_model_args(p)
    p.add_argument("--video_path_1", type=str, required=True,
                   help="motion source")
    p.add_argument("--video_path_2", type=str, required=True,
                   help="appearance source")
    p.add_argument("--diff_motion", action="store_true",
                   help="reconstruct video 2 with the camera motion of "
                        "video 1 (the dual-encoder AMDModel only)")
    p.add_argument("--output_path", type=str, default="output/cross.mp4")
    p.add_argument("--sample_step", type=int, default=20)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--use_ema", action="store_true",
                   help="load the EMA weights of a trainer checkpoint")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = common.load_amd(args, device)
    if args.diff_motion and not isinstance(model, AMDModel):
        raise SystemExit(
            "--diff_motion requires the dual-encoder AMDModel "
            "(--model_type AMD_S or AMD_L): sample_diff_motion's "
            "encode_diff_motion only exists there")
    vae = common.build_vae(args, device)
    kw = dict(window=args.video_frames,
              sample_size=common.sample_size(model, vae))
    if args.diff_motion:
        AMDDiffMotionPipeline(vae, model, **kw).sample_diff(
            args.video_path_2, args.video_path_1, args.output_path,
            video_sample_step=args.sample_step, fps=args.fps,
            generator=common.draws(device, 0))
    else:
        AMDCrossVideoPipeline(vae, model, **kw).sample_cross(
            args.video_path_1, args.video_path_2, args.output_path,
            video_sample_step=args.sample_step, fps=args.fps,
            generator=common.draws(device, 0))
    print("saved:", args.output_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
