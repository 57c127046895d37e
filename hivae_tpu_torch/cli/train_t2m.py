"""Train the label-to-motion (T2M) head with the port (the counterpart of
the JAX package's ``train_t2m.py``: the same flags, names and defaults,
plus ``--device``, ``--resume_training`` and ``--dist_backend``).

    python -m hivae_tpu_torch.cli.train_t2m --amd_config config.json \
        --amd_ckpt amd.safetensors --video_dir ucf101/ --output_dir exp \
        --exp_name t2m [--t2m_config t2m.json] [--device cpu]

A frozen AMD_N (``AMDModelNew``) gives the motion targets on the fly:
each step VAE-encodes the clip, its reference frame (repeated over the
clip), and their grey twins, each a posterior sample with its own draw,
and runs the AMD model's ``encode``; the camera target is cut to
``camera_token_num`` sites of ``camera_channel`` channels and the object
target to ``object_token_num`` tokens of ``object_channel`` channels, and
the head trains on its velocity MSE with AdamW (``training/train_state.py``:
the JAX package's schedule, clipping and EMA); ``grad_norm`` is the global
norm of the raw gradients. The head's weights are fp32; ``--mp bf16`` (and
``fp16``) computes it under bf16 autocast and holds the frozen models in
bf16, as the JAX CLI computes in bf16. The labels are the indices of the
clips' parent directory names (``LabelVideoDataset``, UCF-101's layout).

The run writes the ``T2MConfig`` as ``config.json`` to
``<output_dir>/<exp_name>``, prints the loss every 50 steps, saves a
checkpoint every ``--save_checkpoint_interval_step`` steps and at the end,
and prints the final metrics; ``--resume_training true`` continues from
the newest checkpoint (the JAX CLI always starts anew). Over several
ranks (``torchrun`` or ``HIVAE_MULTIHOST=1``, as ``cli.train_a2m``) it
trains data parallel: ``--train_batch_size`` is the global batch and each
rank loads its share from its shard of the tree (``common.HeadTrainer``).

Refused up front with a ``ValueError`` naming the cause, where the JAX CLI
fails: a frozen model other than AMD_N's ``AMDModelNew`` with both motion
streams (the JAX CLI builds ``AMDModel`` for every other type), a head
that asks for more object tokens, or wider object or camera tokens, than
the AMD model gives (``check_pairing``; at the default ``T2MConfig``,
``object_token_num`` 16 against AMD_N's 4 object tokens), a reference
latent that is not the head's ``refimg`` grid, and a dataset that yields
no batch. A label past ``num_classes`` is refused too (the JAX package
clamps the index and trains on another class's embedding).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

import torch

from ..data.datasets import LabelVideoDataset
from ..models import amd as amd_mod
from ..models import t2m as t2m_mod
from ..models import vae as vae_mod
from ..parallel import comm
from ..training import checkpoint as ckpt_lib
from ..utils.misc import print_param_num
from . import common
from .train_amd import str2bool



def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--output_dir", type=str, default="exp/t2m")
    p.add_argument("--exp_name", type=str, default="t2m")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mp", type=str, default="bf16",
                   help="bf16/fp16: bf16 autocast over fp32 head weights, "
                        "bf16 frozen models; anything else: fp32")
    p.add_argument("--max_train_steps", type=int, default=100_000)
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA of params on device; 0 disables")
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--save_checkpoint_interval_step", type=int, default=2000)
    p.add_argument("--t2m_config", type=str, default=None,
                   help="json T2MConfig overrides")
    p.add_argument("--amd_config", type=str, required=True)
    p.add_argument("--amd_ckpt", type=str, required=True)
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--model_type", type=str, default="AMD_N")
    p.add_argument("--video_dir", type=str, required=True,
                   help="class-labeled video tree (UCF-101 layout)")
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


def check_frozen(model_type: str, amd_cfg: amd_mod.AMDConfig) -> None:
    """The frozen model must be AMD_N's ``AMDModelNew`` with a camera and
    an object stream: the head trains on its ``encode`` triple. (The JAX
    CLI builds ``AMDModelNew`` for AMD_N only, ``AMDModel`` for every other
    type, and refuses those; so does the port, AMD_S_Camera included,
    whose ``AMDModelNew`` has no object stream.)"""
    if model_type != "AMD_N":
        raise ValueError(
            f"train_t2m: --model_type {model_type}: the head trains on "
            "AMDModelNew.encode's (camera_target, object_source, "
            "object_target), which the JAX CLI builds for AMD_N only (an "
            f"AMDModel for {model_type}); use --model_type AMD_N")
    if not (amd_cfg.use_camera and amd_cfg.use_object):
        raise ValueError(
            f"train_t2m: the AMD config has use_camera={amd_cfg.use_camera}"
            f", use_object={amd_cfg.use_object}; the head needs both motion "
            "streams")


def check_pairing(cfg: t2m_mod.T2MConfig, amd_cfg: amd_mod.AMDConfig,
                  latent_shape) -> None:
    """Refuse a head whose token counts, token widths or reference grid
    the frozen AMD model and SD-VAE do not give: ``latent_shape`` is one
    frame's (C, h, w) latent."""
    otn, ao = cfg.object_token_num, amd_cfg.object_motion_token_num
    if otn > ao:
        raise ValueError(
            f"train_t2m: T2MConfig.object_token_num {otn} > the AMD model's "
            f"{ao} object tokens a frame (object_motion_token_num): the "
            f"head's velocity takes {otn} rows of [object; alignment; "
            f"camera] tokens against a {ao}-token target (the JAX step "
            f"fails on that broadcast); set object_token_num <= {ao}")
    for name, want, have, amd_name in (
            ("object_channel", cfg.object_channel,
             amd_cfg.object_motion_token_channel,
             "object_motion_token_channel"),
            ("camera_channel", cfg.camera_channel,
             amd_cfg.camera_motion_token_channel,
             "camera_motion_token_channel")):
        if want > have:
            raise ValueError(
                f"train_t2m: T2MConfig.{name} {want} > the AMD model's "
                f"{amd_name} {have}: the cut tokens are {have} wide and "
                f"the head's input layer takes {want}")
    grid = (cfg.refimg_dim, cfg.refimg_height, cfg.refimg_width)
    if tuple(latent_shape) != grid:
        raise ValueError(
            f"train_t2m: the reference latents are {tuple(latent_shape)} "
            f"(C, h, w) a frame and T2MConfig's (refimg_dim, refimg_height, "
            f"refimg_width) is {grid}: set --sample_size or the config")


def check_labels(cfg: t2m_mod.T2MConfig, dataset: LabelVideoDataset) -> None:
    if len(dataset.classes) > cfg.num_classes:
        raise ValueError(
            f"train_t2m: the video tree has {len(dataset.classes)} classes "
            f"and T2MConfig.num_classes is {cfg.num_classes}")


@dataclasses.dataclass
class T2MDraws:
    """The draws of one step, in the JAX step's order: the posterior noise
    of the clip's encode, of the reference's, of the grey clip's and of
    the grey reference's (each (N*T, C, h, w)), then the head's timestep
    (N,) and flow noise (N*T, object_token_num, object_channel). The draws
    are the global batch's (each rank keeps its rows); a field left None
    is drawn from the step's generator."""

    video: Optional[torch.Tensor] = None
    ref: Optional[torch.Tensor] = None
    grey: Optional[torch.Tensor] = None
    ref_grey: Optional[torch.Tensor] = None
    timestep: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None


class T2MTrainer(common.HeadTrainer):
    """The head (fp32 weights, trained) and the frozen AMD model and VAE;
    the optimizer state and checkpoints of ``common.HeadTrainer``."""

    def __init__(self, head: t2m_mod.Label2MotionDiffusionDecoder, amd, vae,
                 args, out_dir: str):
        super().__init__(head, args, out_dir)
        self.head, self.amd, self.vae = head, amd, vae

    def _encode(self, pixels, noise, gen):
        """Posterior-sample latents of (N, T, 3, H, W) pixels, in the
        frozen models' dtype."""
        f = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        n, t, _, h, w = pixels.shape
        if noise is None:
            noise = self.randn((n * t, self.vae.cfg.latent_channels,
                                 h // f, w // f), gen)
        return vae_mod.vae_encode(self.vae, pixels, noise=noise)

    def targets(self, batch, d: T2MDraws, gen):
        """(camera target cut to the head's tokens, object target cut,
        reference latents (N, T, C, h, w))."""
        c = self.head.cfg
        dtype = next(self.amd.parameters()).dtype
        video = self._encode(batch["videos"], d.video, gen)
        ref = self._encode(batch["ref_img"], d.ref, gen)
        grey = self._encode(batch["grey_videos"], d.grey, gen)
        ref_grey = self._encode(batch["ref_grey_img"], d.ref_grey, gen)
        cam_t, _, obj_t = self.amd.encode(video.to(dtype), ref.to(dtype),
                                          grey.to(dtype), ref_grey.to(dtype))
        cam = cam_t[:, :, :c.camera_token_num, :c.camera_channel].float()
        obj = obj_t[:, :c.object_token_num, :c.object_channel].float()
        return cam, obj, ref.float()

    def loss_and_grads(self, batch, draws: Optional[T2MDraws] = None):
        """(metrics of fp32 scalars, fp32 grads in parameter order) of
        this rank's rows of a batch on the device; ``draws`` are the global
        batch's, and unset ones come from the generator of (seed, step)."""
        g = draws or T2MDraws()
        d = self.own_rows(g)
        c = self.head.cfg
        gen = self.generator()
        with torch.no_grad():
            cam, obj, ref = self.targets(batch, d, gen)
        n, t = ref.shape[:2]
        dp = self.mesh.dp_size
        # the head's conditioning tile is the global batch's: the global
        # timesteps and labels, and this rank's window of the N*T rows
        timestep = g.timestep
        if timestep is None:
            timestep = torch.randint(0, c.num_steps + 1, (n * dp,),
                                     generator=gen, device=self.device)
        noise = d.noise
        if noise is None:
            noise = self.randn(obj.shape, gen)
        label, rows = batch["label"], None
        if dp > 1:
            label = comm.all_gather(label, self.mesh.dp_group, 0)
            i = self.mesh.dp_index
            rows = slice(i * n * t, (i + 1) * n * t)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.autocast):
            out = self.head(cam, obj, label, ref,
                            timestep.to(self.device).float(),
                            noise=noise.to(self.device), rows=rows)
            loss = self.head.loss(out)
        return {"loss": loss.detach().float()}, self.grads(loss)


def load_config(args) -> t2m_mod.T2MConfig:
    overrides = {}
    if args.t2m_config:
        with open(args.t2m_config) as f:
            overrides = json.load(f)
    return t2m_mod.T2MConfig.from_dict({"num_frames": args.video_frames,
                                        **overrides})


def build(args, device: torch.device):
    """(config, head, frozen AMD, frozen VAE, dataset) of the arguments,
    after the refusals."""
    cfg = load_config(args)
    with open(args.amd_config) as f:
        amd_cfg = amd_mod.AMDConfig.from_dict(json.load(f))
    check_frozen(args.model_type, amd_cfg)
    down = 2 ** (len(common.VAE_CONFIG.block_out_channels) - 1)
    check_pairing(cfg, amd_cfg, (common.VAE_CONFIG.latent_channels,
                                 args.sample_size // down,
                                 args.sample_size // down))
    dataset = LabelVideoDataset(args.video_dir,
                                sample_n_frames=args.video_frames,
                                sample_size=args.sample_size, use_grey=True)
    check_labels(cfg, dataset)
    frozen = torch.bfloat16 if args.mp in ("bf16", "fp16") else torch.float32
    amd = common.load_amd(args, device, dtype=frozen).requires_grad_(False)
    vae = common.build_vae(args, device, dtype=frozen).requires_grad_(False)
    torch.manual_seed(args.seed)
    head = t2m_mod.Label2MotionDiffusionDecoder(cfg, device,
                                                torch.float32).train()
    return cfg, head, amd, vae, dataset


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = common.start(args)
    try:
        cfg, head, amd, vae, dataset = build(args, device)
        out_dir = os.path.join(args.output_dir, args.exp_name)
        os.makedirs(out_dir, exist_ok=True)
        trainer = T2MTrainer(head, amd, vae, args, out_dir)
        if trainer.mesh.is_first:
            ckpt_lib.save_config(cfg.to_dict(), out_dir)
            print_param_num("Label2MotionDiffusionDecoder", head)
        loader = common.training_loader(dataset, args, trainer.mesh)
        common.run_training_loop(trainer, loader, args)
    finally:
        common.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
