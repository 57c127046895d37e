"""What the CLIs share: the model flags, the AMD model built from a
JAX-schema ``config.json`` with its checkpoint (its ``attn_impl`` installed
for every attention call, as the JAX CLIs' ``load_amd`` does), the SD-VAE,
the process group of a multi-rank launch, and the trainer, loader and
loop of the head training CLIs (``train_a2m``, ``train_t2m``,
``train_mae``), one card or data parallel over the ranks of a launch."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os

from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.datasets import DataLoader
from ..models import amd as amd_mod
from ..models import vae as vae_mod
from ..ops.attention import install_attn_impl
from ..parallel import comm
from ..parallel import mesh as mesh_lib
from ..training import checkpoint as ckpt_lib
from ..training.train_state import TrainState, global_norm, make_optimizer
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


_started = False   # whether ``start`` began the process group


def start(args) -> torch.device:
    """This process's device: under a multi-rank launch (``torchrun`` or
    ``HIVAE_MULTIHOST=1``) the process group is started first, on
    ``args.dist_backend``, and the device is this rank's. A process group
    the caller started already is used as it is, and ``finish`` leaves it
    to the caller: ``chip_smoke.py``'s CLI phase, which calls several
    CLIs' ``main`` in one spawn of ranks, is the one program that does
    so. ``finish`` ends the group ``start`` began."""
    import torch.distributed as dist

    global _started
    if mesh_lib.launched() and dist.is_initialized():
        dev = torch.device(args.device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if mesh_lib.launched():
        _started = True
        return mesh_lib.init_distributed(args.dist_backend, args.device)[2]
    return resolve_device(args.device)


def finish() -> None:
    """End the process group ``start`` began under a multi-rank launch."""
    import torch.distributed as dist

    global _started
    if _started and dist.is_initialized():
        _started = False
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


# -- the head training CLIs --------------------------------------------------

LOG_EVERY = 50         # steps between loss prints
CHECKPOINTS_KEPT = 2   # the newest checkpoints kept, where no flag says


def add_launch_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=[None, "nccl", "gloo"],
                   help="process group backend over several ranks: nccl on "
                        "CUDA and gloo on the CPU by default")


class HeadTrainer:
    """What the head training CLIs share: the trained module's fp32
    parameters under AdamW (``make_optimizer``: the JAX package's schedule,
    clipping and weight decay, ``schedule`` from its warm-up) with the
    optional EMA, each step's generator, the optimizer step and the
    checkpoints of ``<out_dir>/checkpoints`` (the newest ``keep``). A
    subclass gives ``loss_and_grads(batch, draws)`` -> (metrics of fp32
    scalars, fp32 grads in parameter order) of a batch on the device.

    Data parallelism, as the JAX CLIs' ``create_mesh()``: the mesh puts
    every rank of the process group on ``data`` (one rank without one).
    Each rank trains on its rows of the global batch (its loader's shard,
    ``training_loader``); every draw is made for the *global* batch from
    the step's generator, seeded by (seed, step) alike on every rank, and
    the rank keeps its rows (``draw``, ``own_rows``), so a step over ranks
    equals the one-rank step on the same global batch up to the order of
    the sums. The gradients are averaged over the ranks before
    ``grad_norm`` and the clip, the metrics are means over them, the
    frozen models are replicated, and rank 0 alone writes (every rank
    holds the whole state)."""

    def __init__(self, module: torch.nn.Module, args, out_dir: str,
                 keep: int = CHECKPOINTS_KEPT, schedule: str = "constant"):
        self.device = next(module.parameters()).device
        self.mesh = mesh_lib.create_mesh(device_type=self.device.type)
        self.seed = args.seed
        self.autocast = args.mp in ("bf16", "fp16")
        params = dict(module.named_parameters())
        tx = make_optimizer(list(params.values()), args.learning_rate,
                            args.lr_warmup_steps, args.max_train_steps,
                            schedule=schedule)
        self.state = TrainState(params, tx, ema_decay=args.ema_decay)
        self.ckpt = ckpt_lib.CheckpointManager(
            os.path.join(out_dir, "checkpoints"), keep)

    def generator(self) -> torch.Generator:
        """The generator of this step's draws, seeded by (seed, step)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed * 1_000_003 + self.state.step)
        return gen

    def _mine(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of a global draw whose leading dim is a
        multiple of the global batch, clip-major."""
        dp = self.mesh.dp_size
        if x is None or dp == 1 or x.dim() == 0:
            return x
        n = x.shape[0] // dp
        return x[self.mesh.dp_index * n:(self.mesh.dp_index + 1) * n]

    def draw(self, fn, shape) -> torch.Tensor:
        """``fn(global shape)`` (a draw from the step's generator) for this
        rank's draw of ``shape``: the leading dim times the ranks, this
        rank's rows kept."""
        shape = tuple(shape)
        return self._mine(fn((shape[0] * self.mesh.dp_size,) + shape[1:]))

    def randn(self, shape, gen, dtype=None) -> torch.Tensor:
        """This rank's rows of a global normal draw (``draw``)."""
        return self.draw(lambda s: torch.randn(
            s, generator=gen, dtype=dtype, device=self.device), shape)

    def own_rows(self, draws):
        """This rank's rows of the global batch's ``draws`` (a dataclass of
        tensors or None)."""
        return dataclasses.replace(draws, **{
            f.name: self._mine(getattr(draws, f.name))
            for f in dataclasses.fields(draws)})

    def share(self, weight: torch.Tensor) -> torch.Tensor:
        """ranks x this rank's ``weight`` / the ranks' total: the factor
        that turns this rank's weighted mean (a masked loss) into its part
        of the global batch's, once the ranks' means are averaged."""
        if self.mesh.dp_group is None:
            return torch.ones((), device=weight.device)
        total = weight.detach().float().clone()
        comm.all_reduce_([total], self.mesh.dp_group)
        return self.mesh.dp_size * weight.float() / total

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items() if not isinstance(v, list)}

    def grads(self, loss: torch.Tensor) -> List[torch.Tensor]:
        """fp32 gradients of ``loss`` in parameter order, zeros for a
        parameter the loss does not reach, averaged over the ranks."""
        params = list(self.state.params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(params, grads)]
        if self.mesh.dp_group is not None:
            comm.average_(grads, self.mesh.dp_group)
        return grads

    def loss_and_grads(self, batch, draws=None):
        raise NotImplementedError

    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """One optimizer step on this rank's rows (``draws``: the global
        batch's) -> metrics (0-d tensors, means over the ranks),
        ``grad_norm`` (the global norm of the averaged raw gradients)
        included."""
        metrics, grads = self.loss_and_grads(self._to_device(batch), draws)
        metrics = comm.average_metrics(metrics, self.mesh.dp_group)
        metrics["grad_norm"] = global_norm(grads)
        self.state.apply_gradients(grads)
        return metrics

    def save(self) -> Optional[str]:
        """Rank 0 writes the state while the others wait; its path there,
        None elsewhere."""
        path = None
        if self.mesh.is_first:
            path = self.ckpt.save(self.state.step, self.state.state_dict())
        if self.mesh.size > 1:
            import torch.distributed as dist

            dist.barrier()
        return path

    def restore(self) -> None:
        self.state.load_state_dict(self.ckpt.restore(
            map_location=self.device))


def training_loader(dataset, args, mesh: Optional[mesh_lib.Mesh] = None
                    ) -> DataLoader:
    """This rank's loader: its share of the global
    ``args.train_batch_size`` from its shard of the dataset (last batch
    dropped; default: one rank); a batch the ranks do not divide, and a
    dataset that yields no batch, are refused."""
    mesh = mesh or mesh_lib.local_mesh()
    dp = mesh.dp_size
    if args.train_batch_size % dp:
        raise ValueError(
            f"batch size {args.train_batch_size} must be divisible by the "
            f"data-parallel extent {dp} (mesh {dict(mesh.shape)})")
    loader = DataLoader(dataset, args.train_batch_size // dp,
                        num_workers=args.dataloader_num_workers,
                        shard_id=mesh.dp_index, num_shards=dp)
    if len(loader) == 0:
        raise SystemExit(
            "dataset yields ZERO batches (fewer usable items than "
            "train_batch_size with drop_last): the training loop would spin "
            "forever; shrink the batch or add data")
    return loader


def run_training_loop(trainer: HeadTrainer, loader: DataLoader, args
                      ) -> Optional[Dict[str, torch.Tensor]]:
    """``--resume_training`` from the newest checkpoint, then steps over
    the loader's epochs up to ``--max_train_steps``: the loss printed every
    ``LOG_EVERY`` steps, a checkpoint every
    ``--save_checkpoint_interval_step`` and one at the end, and the final
    metrics printed (rank 0 alone prints and writes). Returns the last
    step's metrics (None for no step)."""
    first = trainer.mesh.is_first
    if args.resume_training and trainer.ckpt.latest_step() is not None:
        trainer.restore()
        if first:
            print(f"resumed at step {trainer.state.step}")
    step = trainer.state.step
    metrics = None
    while step < args.max_train_steps:
        for batch in loader:
            if step >= args.max_train_steps:
                break
            metrics = trainer.train_step(batch)
            step = trainer.state.step
            if step % LOG_EVERY == 0 and first:
                print(f"step {step}: loss={float(metrics['loss']):.4f}")
            if step % args.save_checkpoint_interval_step == 0:
                trainer.save()
    trainer.save()
    if metrics is not None and first:
        print("final metrics:", {k: float(v) for k, v in metrics.items()})
    return metrics
