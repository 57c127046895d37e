"""Reconstruction quality of the AMD model over a directory of videos
(the counterpart of the JAX package's ``evaluate.py``, with its flags and
``--device``): each clip is encoded by the SD-VAE, reconstructed by
``models.amd.sample`` (AMD model and VAE in bf16) and decoded, and PSNR
and SSIM (``utils/metrics.py``) are taken against its frames; LPIPS too
when ``--lpips_vgg`` (torchvision VGG16 weights) is given, with the
LPIPS heads of ``--lpips_head``.

    python -m hivae_tpu_torch.cli.evaluate --amd_config config.json \
        --amd_ckpt amd.safetensors --video_dir videos \
        [--lpips_vgg vgg16.safetensors --lpips_head lpips.safetensors] \
        [--output_json result.json] [--device cpu]

A clip that fails is reported (``FAILED <path>: <error>``) and left out;
the printed JSON (``psnr_mean``, ``psnr_std``, ``ssim_mean``,
``lpips_mean``, ``num_videos``: the clips scored) is also written to
``--output_json``. The pixel size is the config's latent size times the
VAE's downsampling (the JAX CLI reads 256^2 frames, the flagship's).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data import video as vio
from ..losses.lpips import LPIPS, lpips_state
from ..models import amd as amd_mod
from ..models import vae as vae_mod
from ..utils import metrics
from ..utils.checkpoint_io import load_safetensors
from ..utils.device import resolve_device
from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_model_args(p)
    p.add_argument("--lpips_vgg", type=str, default=None,
                   help="torchvision vgg16 state dict (.safetensors)")
    p.add_argument("--lpips_head", type=str, default=None,
                   help="LPIPS vgg.pth head weights (.safetensors)")
    p.add_argument("--video_dir", type=str, required=True)
    p.add_argument("--sample_step", type=int, default=20)
    p.add_argument("--max_videos", type=int, default=50)
    p.add_argument("--output_json", type=str, default=None)
    return p.parse_args(argv)


def build_lpips(args, device) -> LPIPS:
    """``LPIPS`` in fp32 with the weights of ``--lpips_vgg`` and
    ``--lpips_head``; a weight the files lack keeps its initial value, as
    the JAX CLI's non-strict conversion leaves it."""
    model = LPIPS().to(device).eval()
    head = load_safetensors(args.lpips_head) if args.lpips_head else None
    state = lpips_state(load_safetensors(args.lpips_vgg), head)
    own = model.state_dict()
    model.load_state_dict({k: v.to(own[k].dtype) for k, v in state.items()
                           if k in own}, strict=False)
    return model


def score_clip(model, vae, lpips, path: str, args, size: int, generator
               ) -> dict:
    """PSNR, SSIM (and LPIPS) of one video's reconstruction."""
    total, fps = vio.video_metadata(path)
    idx = vio.sample_frames_with_fps(total, fps, args.video_frames + 1, 8,
                                     start_index=0)
    frames = vio.read_video_frames(path, idx)
    device = next(model.parameters()).device
    pixels = torch.from_numpy(vio.pixel_transform(frames, size)).to(device)
    dtype = next(model.parameters()).dtype

    def encode(px):
        z = vae_mod.vae_encode(vae, px[None]).to(dtype)
        return z[:, 1:], z[:, :1].expand(z[:, 1:].shape)

    gt_z, ref = encode(pixels)
    kw = {}
    if model.cfg.use_grey:
        grey = torch.from_numpy(vio.pixel_transform(
            vio.to_grayscale(frames), size)).to(device)
        kw = dict(zip(("video_grey", "ref_img_grey"), encode(grey)))
    _, rec_z, _ = amd_mod.sample(model, gt_z, ref,
                                 sample_step=args.sample_step,
                                 generator=generator, **kw)
    rec = vae_mod.vae_decode(vae, rec_z)
    gt = pixels[1:][None]
    out = {"psnr": float(metrics.psnr(rec, gt)),
           "ssim": float(metrics.ssim(rec, gt))}
    if lpips is not None:
        out["lpips"] = float(metrics.lpips_distance(lpips, rec.float(), gt))
    return out


@torch.no_grad()
def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = common.load_amd(args, device)
    vae = common.build_vae(args, device)
    lpips = build_lpips(args, device) if args.lpips_vgg else None
    size = common.sample_size(model, vae)
    videos = common.mp4s(args.video_dir)[:args.max_videos]
    scores = []
    for i, vp in enumerate(videos):
        try:
            s = score_clip(model, vae, lpips, vp, args, size,
                           common.draws(device, i))
        except Exception as e:
            print(f"FAILED {vp}: {e}")
            continue
        scores.append(s)
        line = (f"[{i + 1}/{len(videos)}] {os.path.basename(vp)}: "
                f"PSNR {s['psnr']:.2f} dB  SSIM {s['ssim']:.4f}")
        if lpips is not None:
            line += f"  LPIPS {s['lpips']:.4f}"
        print(line)

    def mean(key, fn=np.mean):
        vals = [s[key] for s in scores if key in s]
        return float(fn(vals)) if vals else None

    result = {"psnr_mean": mean("psnr"), "psnr_std": mean("psnr", np.std),
              "ssim_mean": mean("ssim"), "lpips_mean": mean("lpips"),
              "num_videos": len(scores)}
    print(json.dumps(result))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
