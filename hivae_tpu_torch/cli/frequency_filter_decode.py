"""Offline frequency-band decode visualiser (the counterpart of the JAX
package's ``frequency_filter_decode.py``, with its flags, ``--size`` and
``--device``): SD-VAE-encode a clip, split its latents into bands, decode
each band back to pixels and write one mp4 a band.

    python -m hivae_tpu_torch.cli.frequency_filter_decode \
        --video_path clip.mp4 [--mode fft|wavelet] [--cutoff 0.5] \
        [--vae_ckpt sd-vae.safetensors] [--output_dir freq_out] [--device cpu]

``fft`` splits the (T, H, W) latent volume at ``--cutoff`` into ``low``
and ``high`` (``ops.frequency.freq_3d_split``); ``wavelet`` takes each
frame's Haar bands ``ll``, ``hl``, ``lh``, ``hh`` (``ops.wavelet.dwt2``),
each repeated back to the latent size. The VAE runs in fp32, as the JAX
CLI builds it, so its mid-block attention, (frames, 1, 1024, 512) at
256^2, takes the streaming kernel's fp32 variant on the card: once for
the encode and once for each band's decode.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import video as vio
from ..models import vae as vae_mod
from ..ops import frequency, wavelet
from ..utils.device import resolve_device
from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="freq_out")
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--cutoff", type=float, default=0.5)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--mode", type=str, default="fft",
                   choices=["fft", "wavelet"])
    p.add_argument("--size", type=int, default=256,
                   help="pixel size the frames are resized and cropped to")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def bands(z: torch.Tensor, mode: str, cutoff: float):
    """{band name: (1, T, C, h, w) latents} of the (1, T, C, h, w) clip."""
    if mode == "fft":
        low, high = frequency.freq_3d_split(z.transpose(1, 2), cutoff,
                                            cutoff)
        return {"low": low.transpose(1, 2), "high": high.transpose(1, 2)}

    def up(b):
        return b.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    return {name: up(b)[None] for name, b in
            zip(("ll", "hl", "lh", "hh"), wavelet.dwt2(z[0]))}


@torch.no_grad()
def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    vae = common.build_vae(args, device, dtype=torch.float32)
    total, fps = vio.video_metadata(args.video_path)
    idx = vio.sample_frames_with_fps(total, fps, args.frames, args.fps,
                                     start_index=0)
    frames = vio.read_video_frames(args.video_path, idx)
    pixels = torch.from_numpy(vio.pixel_transform(frames, args.size))
    z = vae_mod.vae_encode(vae, pixels.to(device)[None])
    os.makedirs(args.output_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(args.video_path))[0]
    paths = []
    for band, lat in bands(z, args.mode, args.cutoff).items():
        out = vae_mod.vae_decode_rgb(vae, lat)[0]
        path = os.path.join(args.output_dir, f"{name}_{args.mode}_{band}.mp4")
        vio.write_video(path, np.asarray(out.cpu()), fps=args.fps)
        print("saved:", path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
