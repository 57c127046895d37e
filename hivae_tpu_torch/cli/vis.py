"""Visualise a PosePre A2M head's audio-to-pose predictor with the port
(the counterpart of the JAX package's ``vis.py``: the same flags and
defaults, plus ``--device``).

    python -m hivae_tpu_torch.cli.vis --a2m_config posepre.json \
        --audio_emb_dir emb --pose_video_dir poses --output_path vis.mp4

Each embedding ``<name>.npy`` (T, M, D) of ``--audio_emb_dir`` (sorted,
the first ``--batch``; a ``_emb`` suffix is dropped from the name) pairs
with the pose video ``<name>.mp4`` of ``--pose_video_dir``. From a start
drawn with numpy's global generator, ``--sample_frames`` frames of both
are read; the first pose frame is VAE-encoded (the posterior mode), the
head's ``predict_pose`` predicts the pose latents of every frame from the
embeddings, and the SD-VAE decodes them. The videos are tiled side by
side (``f h (b w) c``) into one video at ``--fps``.

The spec (json ``{model_type, model}``) must name
``A2MModel_CrossAtten_Audio_PosePre``; ``--a2m_ckpt`` is a reference-named
``.safetensors`` or a checkpoint directory of the port's trainer (random
weights from seed 0 when omitted). Everything computes in fp32, as the
JAX CLI does: the VAE's mid-block attentions (1024 tokens of 512) run
the fp32 streaming kernel (one launch each for the encode and the decode);
the predictor's own attentions stay under 256^2 logits.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from ..data import video as vio
from ..models import vae as vae_mod
from ..training import checkpoint as ckpt_lib
from ..utils.device import resolve_device
from . import common
from .a2v_inference import build_a2m

POSEPRE = "A2MModel_CrossAtten_Audio_PosePre"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--a2m_config", type=str, required=True,
                   help="json: {model_type, model: {...}} (PosePre)")
    p.add_argument("--a2m_ckpt", type=str, default=None,
                   help="a reference-named .safetensors or a checkpoint "
                        "directory of the port's trainer (optional: random "
                        "weights)")
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--audio_emb_dir", type=str, required=True,
                   help="*.npy whisper embeddings, (T, M, D)")
    p.add_argument("--pose_video_dir", type=str, required=True,
                   help="pose mp4s named like the embeddings")
    p.add_argument("--output_path", type=str, default="pose_vis.mp4")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--sample_frames", type=int, default=17)
    p.add_argument("--sample_size", type=int, default=256)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda (the default) never falls back "
                        "to the CPU")
    return p.parse_args(argv)


def load_head(args, device):
    """The PosePre head of ``args.a2m_config`` in fp32, with the weights
    of ``args.a2m_ckpt`` where given."""
    with open(args.a2m_config) as f:
        spec = json.load(f)
    if spec["model_type"] != POSEPRE:
        raise ValueError(f"vis: A2M model_type {spec['model_type']} has no "
                         f"pose predictor; it takes {POSEPRE}")
    with common._seeded(device):
        head = build_a2m(spec, device, torch.float32).eval()
    if args.a2m_ckpt:
        if args.a2m_ckpt.endswith(".safetensors"):
            ckpt_lib.load_pretrain_partial(head, args.a2m_ckpt)
        else:
            head.load_state_dict(ckpt_lib.load_trained_params(
                args.a2m_ckpt), strict=True)
    return head


def read_pairs(args):
    """(embeddings (B, F, M, D), pose pixels (B, F, 3, S, S)) in [-1, 1],
    fp32 numpy, of the first ``args.batch`` pairs."""
    embs = sorted(glob.glob(os.path.join(args.audio_emb_dir,
                                         "*.npy")))[:args.batch]
    afs, pvs = [], []
    for e in embs:
        name = os.path.splitext(os.path.basename(e))[0]
        if name.endswith("_emb"):  # the older embedding suffix
            name = name[:-4]
        vp = os.path.join(args.pose_video_dir, name + ".mp4")
        af = np.load(e)
        total, _ = vio.video_metadata(vp)
        usable = min(len(af), total)
        if usable < args.sample_frames:
            raise ValueError(f"{name}: {usable} usable frames, fewer than "
                             f"--sample_frames {args.sample_frames}")
        s = np.random.randint(0, usable - args.sample_frames + 1)
        idx = list(range(s, s + args.sample_frames))
        afs.append(af[idx])
        pvs.append(vio.pixel_transform(vio.read_video_frames(vp, idx),
                                       args.sample_size))
    return (np.stack(afs).astype(np.float32),
            np.stack(pvs).astype(np.float32))


@torch.no_grad()
def predict(head, vae: vae_mod.AutoencoderKL, audio_emb: torch.Tensor,
            pose_pixels: torch.Tensor) -> torch.Tensor:
    """The decoded predicted pose videos (B, F, 3, H, W) uint8 of the
    embeddings (B, F, M, D), the first frame the reference's, and the
    pose pixels, whose first frame is the reference."""
    ref_pose = vae_mod.vae_encode(vae, pose_pixels[:, :1])[:, 0]
    pose = head.predict_pose(audio_emb[:, 1:], audio_emb[:, 0], ref_pose)
    return vae_mod.vae_decode_rgb(vae, pose)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    head = load_head(args, device)
    vae = common.build_vae(args, device, torch.float32)
    afs, pvs = read_pairs(args)
    vis = predict(head, vae, torch.from_numpy(afs).to(device),
                  torch.from_numpy(pvs).to(device)).cpu().numpy()
    grid = vis.transpose(1, 3, 0, 4, 2)  # f h b w c
    grid = grid.reshape(grid.shape[0], grid.shape[1], -1, grid.shape[-1])
    vio.write_video(args.output_path, grid.transpose(0, 3, 1, 2),
                    fps=args.fps)
    print("saved:", args.output_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
