"""Train the masked autoencoder (MAE) on frozen SD-VAE latents with the
port (the counterpart of the JAX package's ``train_mae.py``: the same
flags, names and defaults, plus ``--device``, ``--resume_training`` and
``--dist_backend``).

    python -m hivae_tpu_torch.cli.train_mae --video_dir videos/ \
        --model_type MAE_L --output_dir exp --exp_name mae [--device cpu]

Each step takes one frame of each clip (``VideoClipDataset`` with
``sample_n_frames=1``), VAE-encodes it (a posterior sample) and trains the
MAE on its masked-patch loss at ``--mask_ratio`` with AdamW under the
cosine schedule (``training/train_state.py``) and the optional EMA. The
model's weights are fp32; ``--mp bf16`` (and ``fp16``) computes it under
bf16 autocast and holds the SD-VAE in bf16. The run prints the loss
every 50 steps, saves a checkpoint to ``<output_dir>/<exp_name>/
checkpoints`` every
``--save_checkpoint_interval_step`` steps and at the end, and prints the
final metrics; ``--resume_training true`` continues from the newest
checkpoint (the JAX CLI always starts anew). Over several ranks
(``torchrun`` or ``HIVAE_MULTIHOST=1``, as ``cli.train_a2m``) it trains
data parallel: ``--train_batch_size`` is the global batch and each rank
loads its share from its shard of the videos (``common.HeadTrainer``). A
dataset that yields no batch is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

import torch

from ..data.datasets import VideoClipDataset
from ..models import mae as mae_mod
from ..models import vae as vae_mod
from ..utils.misc import print_param_num
from . import common
from .train_amd import str2bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--output_dir", type=str, default="exp/mae")
    p.add_argument("--exp_name", type=str, default="mae")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mp", type=str, default="bf16",
                   help="bf16/fp16: bf16 autocast over fp32 weights, a "
                        "bf16 SD-VAE; anything else: fp32")
    p.add_argument("--model_type", type=str, default="MAE_S",
                   help="key into hivae_tpu_torch.models.mae.MAE_MODELS "
                        "(MAE_S, MAE_L, or a registered custom factory)")
    p.add_argument("--mask_ratio", type=float, default=0.75)
    p.add_argument("--norm_pix_loss", type=lambda v: v.lower() == "true",
                   default=False)
    p.add_argument("--max_train_steps", type=int, default=100_000)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=1.5e-4)
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA of params on device; 0 disables")
    p.add_argument("--lr_warmup_steps", type=int, default=1000)
    p.add_argument("--save_checkpoint_interval_step", type=int, default=2000)
    p.add_argument("--video_dir", type=str, required=True)
    p.add_argument("--sample_size", type=int, default=256)
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--dataloader_num_workers", type=int, default=8)
    p.add_argument("--resume_training", type=str2bool, default=False,
                   help="continue from the newest checkpoint of the run")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda (the default) never falls back "
                        "to the CPU")
    common.add_launch_args(p)
    return p.parse_args(argv)


@dataclasses.dataclass
class MAEDraws:
    """The draws of one step, in the JAX step's order: the posterior noise
    of the frames' encode (N, C, h, w), then the masking noise (N,
    patches) uniform. The draws are the global batch's (each rank keeps its
    rows); a field left None is drawn from the step's generator."""

    video: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None


class MAETrainer(common.HeadTrainer):
    """The MAE (fp32 weights, trained, under the cosine schedule) and the
    frozen VAE; the optimizer state and checkpoints of
    ``common.HeadTrainer``. Its metrics: the loss, and ``grad_norm`` (the
    JAX CLI reports the loss only)."""

    def __init__(self, model: mae_mod.MaskedAutoencoderViT, vae, args,
                 out_dir: str):
        super().__init__(model, args, out_dir, schedule="cosine")
        self.model, self.vae = model, vae
        self.mask_ratio = args.mask_ratio

    def latents(self, videos, noise=None, gen=None) -> torch.Tensor:
        """(N, 1, 3, H, W) pixels -> (N, C, h, w) posterior-sample latents,
        fp32."""
        f = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        n, t, _, h, w = videos.shape
        if noise is None:
            noise = self.randn((n * t, self.vae.cfg.latent_channels,
                                h // f, w // f), gen)
        z = vae_mod.vae_encode(self.vae, videos, noise=noise).float()
        return z.reshape((-1,) + z.shape[2:])

    def loss_and_grads(self, batch, draws: Optional[MAEDraws] = None):
        """(metrics of fp32 scalars, fp32 grads in parameter order) of
        this rank's rows of a batch on the device; ``draws`` are the global
        batch's, and unset ones come from the generator of (seed, step)."""
        d = self.own_rows(draws or MAEDraws())
        gen = self.generator()
        with torch.no_grad():
            z = self.latents(batch["videos"], d.video, gen)
        mask = d.mask
        if mask is None:   # the model's masking draw, for the global batch
            mask = self.draw(lambda s: torch.rand(
                s, generator=gen, device=self.device),
                (z.shape[0], self.model.num_patches))
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.autocast):
            loss, _, _ = self.model(z, self.mask_ratio, noise=mask)
        return {"loss": loss.detach().float()}, self.grads(loss)


def build(args, device: torch.device):
    """(MAE, frozen VAE, dataset) of the arguments."""
    if args.model_type not in mae_mod.MAE_MODELS:
        raise ValueError(f"--model_type {args.model_type}: one of "
                         f"{sorted(mae_mod.MAE_MODELS)}")
    frozen = torch.bfloat16 if args.mp in ("bf16", "fp16") else torch.float32
    vae = common.build_vae(args, device, dtype=frozen).requires_grad_(False)
    torch.manual_seed(args.seed)
    model = mae_mod.MAE_MODELS[args.model_type](
        device=device, norm_pix_loss=args.norm_pix_loss).train()
    dataset = VideoClipDataset(args.video_dir, sample_n_frames=1,
                               sample_size=args.sample_size)
    return model, vae, dataset


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = common.start(args)
    try:
        model, vae, dataset = build(args, device)
        out_dir = os.path.join(args.output_dir, args.exp_name)
        os.makedirs(out_dir, exist_ok=True)
        trainer = MAETrainer(model, vae, args, out_dir)
        if trainer.mesh.is_first:
            print_param_num(args.model_type, model)
        loader = common.training_loader(dataset, args, trainer.mesh)
        common.run_training_loop(trainer, loader, args)
    finally:
        common.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
