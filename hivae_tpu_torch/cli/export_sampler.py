"""Export the clip reconstruction sampler with ``torch.export`` (the
counterpart of the JAX package's ``export_sampler.py``; ``--platform``
becomes ``--device``).

    python -m hivae_tpu_torch.cli.export_sampler --amd_config config.json \
        --out sampler.pt2 [--amd_ckpt ckpt] [--vae_ckpt vae.safetensors] \
        [--frames 16] [--size 256] [--sample_step 10] [--quant int8] \
        [--device cuda] [--check]

What is exported is ``ClipSampler``: the body of
``pipelines.reconstruct_clip`` as an ``nn.Module`` (SD-VAE encode, motion
encode, the Euler loop of ``--sample_step`` steps, SD-VAE decode to
uint8) with the AMD model and the VAE, in bf16, as its state. Its inputs
are tensors: ``pixels`` and ``grey`` (F+1, 3, size, size) fp32 in
[-1, 1] (``grey`` is read under the config's ``use_grey`` only) and the
start ``noise`` (F, C, h, w) in the compute dtype; ``torch.export`` cannot
take a ``torch.Generator`` the way the JAX artifact takes a key. With no
mask ratio the sampler draws nothing else. ``--quant int8`` exports the
int8 Euler loop and VAE decode: the tables (``ops.quant.quantize_params``)
are buffers of the module and the float weights they replace are
stripped. The attention and FFN-up kernels appear in the graph as the
``torch.library`` custom ops ``hivae::full_block_attention``,
``hivae::stream_attention`` and ``hivae::ffn_up_quant``.

The artifact is ``torch.export.save`` output, weights inside. Unlike the
JAX package's StableHLO artifact it is not self-contained: loading and
running it needs ``hivae_tpu_torch`` imported (its custom ops, and their
kernels' sources to build on first use), and it runs on the device it
was exported for. ``--check`` loads it with ``torch.export.load``, runs
it on zeros and seeded noise and prints the output's shape, dtype and
finiteness.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import torch
from torch import nn

from ..models import amd as amd_mod
from ..models import vae as vae_mod
from ..ops import quant as quant_ops
from ..ops.attention import install_attn_impl
from ..pipelines.pipeline import build_quant_table, reconstruct_clip
from ..training import checkpoint as ckpt_lib
from ..utils.device import resolve_device
from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--amd_config", type=str, required=True)
    p.add_argument("--amd_ckpt", type=str, default=None,
                   help="a port trainer checkpoint or a reference-named "
                        ".safetensors; random init (seed 0) if omitted")
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--sample_step", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="the device the program is exported for")
    p.add_argument("--quant", type=str, default=None, choices=["int8"],
                   help="int8: the Euler loop's DiT and the VAE decode in "
                        "w8a8, the tables in the artifact")
    p.add_argument("--check", action="store_true")
    return p.parse_args(argv)


class _Table(nn.Module):
    """An int8 table (``{layer: {"w8", "scale"[, "bias"]}}``) held as
    buffers, so that it is module state; ``table()`` gives it back."""

    def __init__(self, table: Optional[Dict[str, Dict[str, torch.Tensor]]]):
        super().__init__()
        self.layout = {}
        for name, entry in (table or {}).items():
            for leaf, t in entry.items():
                key = f"{name}.{leaf}".replace(".", "__")
                self.register_buffer(key, t)
                self.layout.setdefault(name, {})[leaf] = key

    def table(self):
        if not self.layout:
            return None
        return {name: {leaf: getattr(self, key) for leaf, key in
                       entry.items()} for name, entry in self.layout.items()}


class ClipSampler(nn.Module):
    """``reconstruct_clip`` as a module: (pixels, grey, noise) -> the
    reconstructed (F+1, 3, H, W) uint8 clip, the start noise replayed
    through ``models.amd.SampleDraws``. ``quant_table`` and
    ``vae_quant_table`` (built before any weight is stripped) run the
    Euler loop and the decode in int8."""

    def __init__(self, vae: vae_mod.AutoencoderKL, amd: nn.Module,
                 sample_step: int, quant_table=None, vae_quant_table=None):
        super().__init__()
        self.vae, self.amd, self.sample_step = vae, amd, sample_step
        self.quant_table = _Table(quant_table)
        self.vae_quant_table = _Table(vae_quant_table)

    def forward(self, pixels: torch.Tensor, grey: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        return reconstruct_clip(
            self.vae, self.amd, pixels,
            grey if self.amd.cfg.use_grey else None,
            amd_mod.SampleDraws(replay=[noise]), self.sample_step,
            quant_table=self.quant_table.table(),
            vae_quant_table=self.vae_quant_table.table())


def example_inputs(amd, frames: int, size: int, device, seed: int = 0):
    """(pixels, grey, noise) of the exported signature: zeros and the
    start noise drawn from ``seed``."""
    c = amd.cfg
    pix = torch.zeros((frames + 1, 3, size, size), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn((frames, c.image_inchannel, c.image_height,
                         c.image_width), generator=gen, device=device
                        ).to(next(amd.parameters()).dtype)
    return pix, pix.clone(), noise


def build_sampler(vae, amd, sample_step: int,
                  quant: Optional[str] = None) -> ClipSampler:
    """The module to export; with ``quant="int8"`` the tables are built
    and the float weights they replace stripped, as the int8 pipeline
    does."""
    qt = build_quant_table(quant, amd, "dit")
    vqt = build_quant_table(quant, vae, "vae")
    for model, table in ((amd, qt), (vae, vqt)):
        if table:
            quant_ops.strip_quantized(model, table)
    sampler = ClipSampler(vae, amd, sample_step, qt, vqt).eval()
    for p in sampler.parameters():
        p.requires_grad_(False)
    return sampler


def export(sampler: ClipSampler, inputs) -> torch.export.ExportedProgram:
    """``torch.export.export`` of ``sampler`` on ``inputs``, grad off."""
    with torch.no_grad():
        return torch.export.export(sampler, tuple(inputs))


def load_models(args, device):
    """AMD_N of ``--amd_config`` at ``--frames`` in bf16 (from seed 0, then
    ``--amd_ckpt`` where given; its ``attn_impl`` installed) and the
    SD-VAE."""
    with open(args.amd_config) as f:
        cfg = amd_mod.AMDConfig.from_dict(json.load(f))
    cfg = cfg.replace(video_frames=args.frames)
    with common._seeded(device):
        amd = amd_mod.AMDModelNew(cfg, device=device,
                                  dtype=torch.bfloat16).eval()
    if args.amd_ckpt:
        if args.amd_ckpt.endswith(".safetensors"):
            report = ckpt_lib.load_pretrain_partial(amd, args.amd_ckpt)
            print(f"converted torch checkpoint; "
                  f"missing={len(report['missing'])}")
        else:
            amd.load_state_dict(ckpt_lib.load_trained_params(args.amd_ckpt),
                                strict=True)
    install_attn_impl(cfg)
    return amd, common.build_vae(args, device)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    amd, vae = load_models(args, device)
    sampler = build_sampler(vae, amd, args.sample_step, args.quant)
    inputs = example_inputs(amd, args.frames, args.size, device)
    t0 = time.perf_counter()
    program = export(sampler, inputs)
    traced = time.perf_counter() - t0
    torch.export.save(program, args.out)
    out = program.graph_signature.user_outputs
    print(f"exported {args.out}: {os.path.getsize(args.out) / 1e6:.2f} MB, "
          f"device={device}, traced in {traced:.1f} s, outputs={out}")
    if args.check:
        loaded = torch.export.load(args.out)
        with torch.no_grad():
            frames = loaded.module()(*inputs)
        finite = bool(torch.isfinite(frames.float()).all())
        print(f"check OK: output {tuple(frames.shape)} {frames.dtype}, "
              f"finite={finite}")
    return program


if __name__ == "__main__":
    main()
