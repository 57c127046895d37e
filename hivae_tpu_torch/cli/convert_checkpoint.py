"""Convert a reference-named torch ``.safetensors`` checkpoint into the
port's checkpoint, and report how its keys map (the counterpart of the JAX
package's ``convert_checkpoint.py``, with its flags and ``--device``).

    python -m hivae_tpu_torch.cli.convert_checkpoint --kind amd_new \
        --config config.json --src model.safetensors --dst ckpt/converted
    python -m hivae_tpu_torch.cli.convert_checkpoint --kind vae \
        --src sd-vae.safetensors --dst ckpt/vae

``--kind``: ``amd`` (the dual-encoder ``AMDModel``), ``amd_new``
(``AMDModelNew``), ``vae`` (the SD-VAE of the published configuration;
diffusers names, old or new, are normalised) or ``a2m`` (the audio A2M
head of a json spec, its ``model`` section or the whole file). The
model is built from seed 0 in fp32, the file's tensors loaded into it
(``training.checkpoint.load_state_partial``), and the keys used, the
model's keys the file lacks and the file's keys the model does not use
are printed; ``--strict`` refuses a file that leaves model keys missing,
as the JAX CLI's does (unused keys are reported only). The
result is written as the port's trainer writes a checkpoint,
``<dst>/checkpoint-0/state.pt`` (``{"params": state dict, "step": 0}``),
which ``cli.common.load_amd`` and ``training.checkpoint
.load_trained_params`` read. No Orbax checkpoint is written: that is the
JAX package's format, which the port does not produce.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..models import a2m as a2m_mod
from ..models import amd as amd_mod
from ..models import vae as vae_mod
from ..training import checkpoint as ckpt_lib
from ..utils.checkpoint_io import load_safetensors, normalize_vae_keys
from ..utils.device import resolve_device
from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kind", type=str, required=True,
                   choices=["amd", "amd_new", "vae", "a2m"])
    p.add_argument("--config", type=str, default=None,
                   help="config.json for model kinds")
    p.add_argument("--src", type=str, required=True)
    p.add_argument("--dst", type=str, required=True)
    p.add_argument("--strict", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model is built and loaded")
    return p.parse_args(argv)


def build_template(args, device) -> torch.nn.Module:
    """The model ``--kind`` names, from seed 0, in fp32."""
    with common._seeded(device):
        if args.kind == "vae":
            return vae_mod.AutoencoderKL(common.VAE_CONFIG, device=device)
        with open(args.config) as f:
            spec = json.load(f)
        if args.kind in ("amd", "amd_new"):
            cfg = amd_mod.AMDConfig.from_dict(spec)
            cls = amd_mod.AMDModelNew if args.kind == "amd_new" else \
                amd_mod.AMDModel
            return cls(cfg, device=device)
        cfg = a2m_mod.A2MConfig.from_dict(spec.get("model", spec))
        return a2m_mod.A2MModelCrossAttnAudio(cfg, variant="audio",
                                              device=device)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.kind != "vae" and not args.config:
        raise SystemExit(f"--kind {args.kind} needs --config")
    device = resolve_device(args.device)
    model = build_template(args, device)
    state = load_safetensors(args.src)
    if args.kind == "vae":
        state = normalize_vae_keys(state)
    report = ckpt_lib.load_state_partial(model, state)
    print(f"converted: {len(state) - len(report['unused'])} keys used, "
          f"{len(report['missing'])} model keys missing, "
          f"{len(report['unused'])} file keys unused")
    if report["missing"]:
        print("missing (first 10):", report["missing"][:10])
    if report["unused"]:
        print("unused (first 10):", report["unused"][:10])
    if args.strict and report["missing"]:
        raise KeyError(f"--strict: missing {len(report['missing'])} keys, "
                       f"e.g. {report['missing'][:10]}")
    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    path = ckpt_lib.CheckpointManager(args.dst, max_to_keep=0).save(
        0, {"params": params, "step": 0})
    print("saved:", path)
    return report


if __name__ == "__main__":
    main()
