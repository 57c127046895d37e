"""Train an audio-to-motion (A2M) head with the port (the counterpart of
the JAX package's ``train_a2m.py``: the same flags, names and defaults,
plus ``--device``, ``--resume_training`` and ``--dist_backend``).

    python -m hivae_tpu_torch.cli.train_a2m --a2m_config a2m.yaml \
        --amd_config config.json --amd_ckpt amd.safetensors \
        --video_dir index.pkl --output_dir exp --exp_name a2m [--device cpu]

A frozen AMD model gives the motion-token targets on the fly: each step
VAE-encodes the clip (``gt_video``) and, once, its reference frame, each a
posterior sample with its own draw, extracts their object-motion tokens,
VAE-encodes the pose stream when the batch has one, and trains the head
on its loss (the per-frame mask-weighted velocity MSE) with AdamW
(``training/train_state.py``: the JAX package's schedule, clipping and
EMA); ``grad_norm`` is the global norm of the raw gradients. The head's
weights are fp32; ``--mp bf16`` (and ``fp16``) computes it under bf16
autocast and holds the AMD model and the SD-VAE in bf16, as the JAX CLI
computes in bf16. The index (``--video_dir``) is a ``.pkl`` list of
{video_path, audio_emb_path[, pose_path]} entries or another source of
``data.datasets.list_videos``; ``--dataset`` picks the reference frame
(the one before the clip, or one from outside it).

The run writes the spec as ``config.json`` to ``<output_dir>/<exp_name>``,
prints the loss every 50 steps, saves a checkpoint every
``--save_checkpoint_interval_step`` steps (the newest
``--checkpoint_total_limit`` kept) and once at the end, and prints the
final metrics; ``cli.a2v_inference --a2m_config <run>/config.json
--a2m_ckpt <run>/checkpoints`` serves it. ``--resume_training true``
continues from the newest checkpoint (the JAX CLI always starts anew).

Over several ranks (one process a card; data parallel, as the JAX CLI
over hosts): ``torchrun --nproc_per_node N -m
hivae_tpu_torch.cli.train_a2m ...`` or ``HIVAE_MULTIHOST=1`` with
``HIVAE_COORDINATOR``/``HIVAE_NUM_PROCESSES``/``HIVAE_PROCESS_ID``;
``--train_batch_size`` is the global batch, which the ranks must divide,
each rank loading its share from its shard of the index; ``--dist_backend
gloo`` where ranks share a card (``common.HeadTrainer``).

Refused up front, where the JAX CLI fails later: the heads that condition
on pose (``A2MModel_CrossAtten_Audio_Pose``, ``_Pose``, ``_PosePre``: its
initialisation passes no pose), LearnableToken and SimpleAdaLN on an index
with a pose stream (its step passes ``pose`` to a head that takes none),
and a dataset that yields no batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

import torch

from ..data.datasets import VideoAudioDataset, VideoAudioRandomRefDataset
from ..models import vae as vae_mod
from ..training import checkpoint as ckpt_lib
from ..utils.misc import print_param_num
from . import common
from .a2v_inference import build_a2m, load_spec, refuse_pose_heads
from .train_amd import str2bool

DATASETS = {"A2MVideoAudio": VideoAudioDataset,
            "A2MVideoAudioPoseRandomRef": VideoAudioRandomRefDataset}
# heads whose training forward takes no pose keyword
NO_POSE_KWARG = ("A2MModel_LearnableToken", "A2MModel_SimpleAdaLN")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--output_dir", type=str, default="exp/a2m")
    p.add_argument("--exp_name", type=str, default="a2m")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mp", type=str, default="bf16",
                   help="bf16/fp16: bf16 autocast over fp32 head weights, "
                        "bf16 frozen models; anything else: fp32")
    p.add_argument("--max_train_steps", type=int, default=100_000)
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA of the head's params; 0 disables")
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--save_checkpoint_interval_step", type=int, default=2000)
    p.add_argument("--checkpoint_total_limit", type=int, default=2)
    # models
    p.add_argument("--a2m_config", type=str, required=True,
                   help="json or yaml: {model_type, model: {...}}")
    p.add_argument("--amd_config", type=str, required=True)
    p.add_argument("--amd_ckpt", type=str, required=True)
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--model_type", type=str, default="AMD_N")
    # data
    p.add_argument("--dataset", type=str, default="A2MVideoAudio",
                   choices=sorted(DATASETS),
                   help="the reference frame: the one before the clip, or "
                        "one drawn from outside it")
    p.add_argument("--video_dir", type=str, required=True,
                   help="pkl list of {video_path, audio_emb_path"
                        "[, pose_path]}")
    p.add_argument("--video_frames", type=int, default=16)
    p.add_argument("--sample_size", type=int, default=256)
    p.add_argument("--dataloader_num_workers", type=int, default=8)
    p.add_argument("--resume_training", type=str2bool, default=False,
                   help="continue from the newest checkpoint of the run")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda (the default) never falls back "
                        "to the CPU")
    common.add_launch_args(p)
    return p.parse_args(argv)


def check_trainable(spec: dict, dataset) -> None:
    """Refuse what the JAX CLI cannot train: a head that conditions on
    pose (its initialisation passes none), and LearnableToken or
    SimpleAdaLN where the index has a pose stream (its step would pass
    ``pose`` to a head that takes none)."""
    refuse_pose_heads(spec, "train_a2m")
    if spec["model_type"] in NO_POSE_KWARG and any(
            m.get("pose_path") for m in dataset.metadata):
        raise ValueError(
            f"train_a2m: A2M model_type {spec['model_type']} takes no pose "
            "input, and the index has pose_path entries (the step encodes "
            "and passes the pose stream); the JAX CLI's step fails on it. "
            "Drop pose_path from the index")


@dataclasses.dataclass
class A2MDraws:
    """The draws of one step, in the JAX step's order: the posterior noise
    of the clip's encode (N*F, C, h, w), of the reference frame's (N, C,
    h, w), of the pose stream's and of the reference pose's (with a pose
    stream), then the head's timestep (N,) and flow noise (N, F, L, D).
    The draws are the global batch's (each rank keeps its rows); a field
    left None is drawn from the step's generator."""

    video: Optional[torch.Tensor] = None
    ref: Optional[torch.Tensor] = None
    pose: Optional[torch.Tensor] = None
    ref_pose: Optional[torch.Tensor] = None
    timestep: Optional[torch.Tensor] = None
    z0: Optional[torch.Tensor] = None


class A2MTrainer(common.HeadTrainer):
    """The head (fp32 weights, trained) and the frozen AMD model and VAE;
    the optimizer state and the newest ``--checkpoint_total_limit``
    checkpoints of ``<out_dir>/checkpoints`` (``common.HeadTrainer``)."""

    def __init__(self, head, amd, vae: vae_mod.AutoencoderKL, args,
                 out_dir: str):
        super().__init__(head, args, out_dir,
                         keep=args.checkpoint_total_limit)
        self.head, self.amd, self.vae = head, amd, vae

    def _encode(self, pixels, noise, gen):
        """Posterior-sample latents of (N, T, 3, H, W) pixels, fp32."""
        f = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        n, t, _, h, w = pixels.shape
        if noise is None:
            noise = self.randn((n * t, self.vae.cfg.latent_channels,
                                 h // f, w // f), gen)
        return vae_mod.vae_encode(self.vae, pixels, noise=noise).float()

    def _motion(self, latents):
        dtype = next(self.amd.parameters()).dtype
        return self.amd.extract_motion(latents.to(dtype)).float()

    def loss_and_grads(self, batch, draws: Optional[A2MDraws] = None):
        """(metrics of fp32 scalars, fp32 grads in parameter order) of
        this rank's rows of a batch on the device; ``draws`` are the global
        batch's, and unset ones come from the generator of (seed, step)."""
        d = self.own_rows(draws or A2MDraws())
        gen = self.generator()
        with torch.no_grad():
            gt_z = self._encode(batch["gt_video"], d.video, gen)
            # the reference is one frame repeated by the dataset: encoded
            # once, with its own draw
            ref_z = self._encode(batch["ref_video"][:, :1], d.ref, gen)
            motion_gt = self._motion(gt_z)
            ref_motion = self._motion(ref_z)[:, 0]
            pose_kw = {}
            if "gt_pose" in batch:
                pose_kw = dict(
                    pose=self._encode(batch["gt_pose"], d.pose, gen),
                    ref_pose=self._encode(batch["ref_pose"][:, None],
                                          d.ref_pose, gen)[:, 0])
        # the head's flow draws, as its forward makes them (timestep,
        # then noise), for the global batch
        timestep = d.timestep
        if timestep is None:
            timestep = self.draw(lambda s: torch.randint(
                0, self.head.cfg.num_step + 1, s, generator=gen,
                device=self.device), motion_gt.shape[:1])
        z0 = d.z0
        if z0 is None:
            z0 = self.randn(motion_gt.shape, gen, motion_gt.dtype)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.autocast):
            ld = self.head(motion_gt, ref_motion, audio=batch["gt_audio"],
                           ref_audio=batch["ref_audio"], mask=batch["mask"],
                           timestep=timestep, z0=z0, **pose_kw)
        # the masked mean of this rank's frames, as its part of the
        # global batch's masked mean
        share = self.share(batch["mask"].sum())
        ld = {k: v * share for k, v in ld.items()}
        return ({k: v.detach().float() for k, v in ld.items()},
                self.grads(ld["loss"]))


def build(args, device: torch.device):
    """(spec, head, frozen AMD, frozen VAE, dataset) of the arguments; the
    refusals of ``check_trainable`` first."""
    spec = load_spec(args.a2m_config)
    dataset = DATASETS[args.dataset](args.video_dir,
                                     sample_n_frames=args.video_frames,
                                     sample_size=args.sample_size)
    check_trainable(spec, dataset)
    frozen = torch.bfloat16 if args.mp in ("bf16", "fp16") else torch.float32
    amd = common.load_amd(args, device, dtype=frozen).requires_grad_(False)
    vae = common.build_vae(args, device, dtype=frozen).requires_grad_(False)
    torch.manual_seed(args.seed)
    head = build_a2m(spec, device, torch.float32).train()
    return spec, head, amd, vae, dataset


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = common.start(args)
    try:
        spec, head, amd, vae, dataset = build(args, device)
        out_dir = os.path.join(args.output_dir, args.exp_name)
        os.makedirs(out_dir, exist_ok=True)
        trainer = A2MTrainer(head, amd, vae, args, out_dir)
        if trainer.mesh.is_first:
            ckpt_lib.save_config(spec, out_dir)
            print_param_num(spec["model_type"], head)
        loader = common.training_loader(dataset, args, trainer.mesh)
        common.run_training_loop(trainer, loader, args)
    finally:
        common.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
