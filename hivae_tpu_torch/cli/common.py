"""What the inference CLIs share: the model flags, the AMD model built
from a JAX-schema ``config.json`` with its checkpoint (its ``attn_impl``
installed for every attention call, as the JAX CLIs' ``load_amd`` does),
the SD-VAE, and the process group of a multi-rank launch."""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os

import torch

from ..models import amd as amd_mod
from ..models import vae as vae_mod
from ..ops.attention import install_attn_impl
from ..parallel import mesh as mesh_lib
from ..training import checkpoint as ckpt_lib
from ..utils.device import resolve_device
from ..utils.checkpoint_io import load_safetensors, normalize_vae_keys

# The SD-VAE the CLIs build (the SD-VAE's published configuration)
VAE_CONFIG = vae_mod.VAEConfig()


def add_model_args(p: argparse.ArgumentParser, frames: int = 16) -> None:
    p.add_argument("--amd_config", type=str, required=True,
                   help="config.json written at training time")
    p.add_argument("--amd_ckpt", type=str, required=True,
                   help="a checkpoint of the port's trainer (a "
                        "checkpoint-N directory or the directory holding "
                        "them) or a reference-named .safetensors")
    p.add_argument("--vae_ckpt", type=str, default=None,
                   help="SD-VAE .safetensors (diffusers names, old or new)")
    p.add_argument("--video_frames", type=int, default=frames,
                   help="sampling window")
    p.add_argument("--model_type", type=str, default="AMD_N",
                   help="the class its factory builds, on the config: "
                        "AMDModelNew for AMD_N and AMD_S_Camera, the "
                        "dual-encoder AMDModel for AMD_S and AMD_L")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda (the default) never falls back "
                        "to the CPU")


def start(args) -> torch.device:
    """This process's device: under a multi-rank launch (``torchrun`` or
    ``HIVAE_MULTIHOST=1``) the process group is started first, on
    ``args.dist_backend``, and the device is this rank's. ``finish`` ends
    the group."""
    if mesh_lib.launched():
        return mesh_lib.init_distributed(args.dist_backend, args.device)[2]
    return resolve_device(args.device)


def finish() -> None:
    """End the process group ``start`` began under a multi-rank launch."""
    import torch.distributed as dist

    if mesh_lib.launched() and dist.is_initialized():
        dist.destroy_process_group()


def writes_files() -> bool:
    """True on the rank that writes outputs: rank 0, or a lone process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


@contextlib.contextmanager
def _seeded(device):
    """Random initialisation from seed 0 (the JAX CLIs initialise from
    ``PRNGKey(0)``): every rank of a launch builds the same weights where
    no checkpoint fills them. The caller's random state is restored."""
    cuda = [device] if torch.device(device).type == "cuda" else []
    with torch.random.fork_rng(devices=cuda):
        torch.manual_seed(0)
        yield


def load_amd(args, device, dtype: torch.dtype = torch.bfloat16):
    """The AMD model of ``args.amd_config`` (its window set to
    ``args.video_frames``) with the weights of ``args.amd_ckpt``, in
    ``dtype``: the class ``models.amd.AMD_MODELS[--model_type]`` builds
    (``AMDModelNew`` for AMD_N and AMD_S_Camera, the dual-encoder
    ``AMDModel`` for AMD_S and AMD_L), so that a checkpoint the trainer
    wrote for the type loads. (The JAX CLIs build ``AMDModel`` for every
    type but AMD_N, AMD_S_Camera included, which its trainer builds as
    ``AMDModelNew``.) ``args.use_ema`` (where the CLI has it) takes a trainer checkpoint's
    EMA weights. The config's ``attn_impl`` is installed (``ring``: a ring
    of every rank, or ``auto`` with a warning on one)."""
    with open(args.amd_config) as f:
        cfg = amd_mod.AMDConfig.from_dict(json.load(f))
    cfg = cfg.replace(video_frames=args.video_frames)
    if args.model_type not in amd_mod.AMD_CLASSES:
        raise ValueError(f"--model_type {args.model_type}: one of "
                         f"{sorted(amd_mod.AMD_CLASSES)}")
    cls = amd_mod.AMD_CLASSES[args.model_type]
    with _seeded(device):
        model = cls(cfg, device=device, dtype=dtype).eval()
    if args.amd_ckpt.endswith(".safetensors"):
        report = ckpt_lib.load_pretrain_partial(model, args.amd_ckpt)
        print(f"converted torch checkpoint; missing={len(report['missing'])}")
    else:
        model.load_state_dict(ckpt_lib.load_trained_params(
            args.amd_ckpt, getattr(args, "use_ema", False)), strict=True)
    install_attn_impl(cfg)
    return model


def build_vae(args, device, dtype: torch.dtype = torch.bfloat16
              ) -> vae_mod.AutoencoderKL:
    """The SD-VAE, with the weights of ``args.vae_ckpt`` when given (else
    its random initialisation, from seed 0)."""
    with _seeded(device):
        vae = vae_mod.AutoencoderKL(VAE_CONFIG, device=device,
                                    dtype=dtype).eval()
    if args.vae_ckpt:
        ckpt_lib.load_state_partial(
            vae, normalize_vae_keys(load_safetensors(args.vae_ckpt)))
    return vae


def sample_size(amd, vae: vae_mod.AutoencoderKL) -> int:
    """The pixel size whose latents the model takes: its latent height
    times the VAE's downsampling."""
    return amd.cfg.image_height * 2 ** (len(vae.cfg.block_out_channels) - 1)


def draws(device, seed: int) -> amd_mod.DrawSource:
    """The draw source of one video: a generator on ``device`` seeded with
    ``seed`` (the video's index)."""
    return torch.Generator(device=device).manual_seed(seed)


def mp4s(video_dir: str):
    """The mp4 files under ``video_dir``, recursively, in sorted order."""
    return sorted(glob.glob(os.path.join(video_dir, "**", "*.mp4"),
                            recursive=True))
