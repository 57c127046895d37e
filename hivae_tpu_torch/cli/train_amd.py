"""Train an AMD model from a directory of mp4 files with the port (the
counterpart of the JAX package's ``train_amd.py``: the same flags, names
and defaults, plus ``--device`` and ``--dist_backend``).

    python -m hivae_tpu_torch.cli.train_amd --video_dir videos \
        --amd_config configs/amd/amd_n_t1d512_spatial.json \
        --output_dir exp --exp_name amd [--device cpu]

Over several ranks (one process a card): ``torchrun --nproc_per_node N -m
hivae_tpu_torch.cli.train_amd ... --mesh d,f,t``, or ``HIVAE_MULTIHOST=1``
with ``HIVAE_COORDINATOR``/``HIVAE_NUM_PROCESSES``/``HIVAE_PROCESS_ID`` on
each process (the JAX CLI's variables; ``LOCAL_RANK`` picks the card).
``--mesh`` (default: every rank on ``data``) must multiply to the number
of ranks; ``--train_batch_size`` is the global batch, which must divide by
data * fsdp, and each rank loads its share (the loader's shard of the
videos; ranks of one ``tensor`` group load the same). ``--attn_impl``
(auto, xla, pallas, ring; with ``--amd_config``, the config's
``attn_impl``) is installed for every attention call; ``ring`` shards
the attention sequences over ``tensor``. NCCL is the
backend on CUDA unless ``--dist_backend gloo`` asks for gloo (ranks that
share one card). Rank 0 alone writes ``config.json``, ``args.txt``, the
tracker and the checkpoints.

The model comes from ``--amd_config`` (the class the factory of
``--model_type`` builds: ``AMDModelNew`` for AMD_N and AMD_S_Camera, the
dual-encoder ``AMDModel`` for AMD_S and AMD_L) or from the flags
(``AMD_N``, ``AMD_S`` and ``AMD_L`` at the flags' widths, any other name of
``models.amd.AMD_MODELS`` through its factory, as the JAX CLI builds
them), with fp32 master weights; ``--mp bf16`` (and ``fp16``) computes under bf16 autocast and
holds the SD-VAE in bf16, ``--mp no`` computes in fp32. The run writes
``config.json`` and ``args.txt`` to ``<output_dir>/<exp_name>``, trains
with checkpoints under ``checkpoints/``, saves once more at the end and
prints the final metrics. Scalars go to TensorBoard (``tracker/``) where
``torch.utils.tensorboard`` imports, else to stdout.

``--mesh d,f,t`` with t > 1 and no ring attention splits the weights over
``tensor`` (Megatron column and row parallelism on the JAX package's
rules, ``parallel/tensor_parallel.py``), with FSDP over ``fsdp`` on top.

Refused: ``AMD_S_Rec``/``AMD_S_RecSplit`` (``AMDModelRec`` has a forward
and a loss only; the JAX trainer cannot run it either).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import torch

from ..data.datasets import DataLoader, RandomPairDataset, VideoClipDataset
from ..models import amd as amd_mod
from ..parallel import mesh as mesh_lib
from ..training import checkpoint as ckpt_lib
from ..training.trainer import AMDTrainer, TrainConfig
from ..utils.misc import print_param_num, save_args
from . import common

DATASETS = {"AMDConsecutiveVideo": VideoClipDataset,
            "AMDRandomPair": RandomPairDataset}


def str2bool(v):
    if isinstance(v, bool):
        return v
    return v.lower() in ("yes", "true", "t", "y", "1")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # run
    p.add_argument("--output_dir", type=str, default="exp/amd")
    p.add_argument("--exp_name", type=str, default="amd")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mp", type=str, default="bf16",
                   choices=["bf16", "fp16", "no"],
                   help="bf16/fp16: bf16 autocast over fp32 master "
                        "weights; no: fp32")
    p.add_argument("--max_train_steps", type=int, default=100_000)
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--save_checkpoint_interval_step", type=int, default=2000)
    p.add_argument("--checkpoint_total_limit", type=int, default=2)
    p.add_argument("--eval_interval_step", type=int, default=2000)
    p.add_argument("--resume_training", type=str2bool, default=False)
    p.add_argument("--profile_steps", type=int, default=0,
                   help="record N steps with torch.profiler into "
                        "<output_dir>/<exp_name>/profile")
    p.add_argument("--mu_dtype", type=str, default=None,
                   choices=[None, "bf16"],
                   help="bf16 Adam first moments")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--transfer_dtype", type=str, default="fp32",
                   choices=["fp32", "bf16"],
                   help="host->device batch dtype; bf16 halves the bytes "
                        "copied")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA of the params (e.g. 0.999); checkpoints carry "
                        "both. 0 disables")
    p.add_argument("--nan_policy", type=str, default="none",
                   choices=["none", "halt", "skip"],
                   help="non-finite loss: halt = dump the batch and raise, "
                        "skip = drop the step and continue")
    p.add_argument("--mesh", type=str, default=None,
                   help="d,f,t: the (data, fsdp, tensor) mesh of ranks; "
                        "default every rank on data")
    # model
    p.add_argument("--model_type", type=str, default="AMD_N",
                   help="AMD_N, AMD_S, AMD_L (the flags' widths) or another "
                        "factory of AMD_MODELS; AMD_S_Rec and "
                        "AMD_S_RecSplit are refused")
    p.add_argument("--amd_config", type=str, default=None)
    p.add_argument("--pretrain_path", type=str, default=None)
    p.add_argument("--video_frames", type=int, default=16)
    p.add_argument("--image_height", type=int, default=32)
    p.add_argument("--image_width", type=int, default=32)
    p.add_argument("--use_filter", type=str2bool, default=True)
    p.add_argument("--use_grey", type=str2bool, default=True)
    p.add_argument("--use_camera", type=str2bool, default=True)
    p.add_argument("--use_object", type=str2bool, default=True)
    p.add_argument("--use_camera_down", type=str2bool, default=False)
    p.add_argument("--use_regularizers", type=str2bool, default=False)
    p.add_argument("--motion_type", type=str, default="plus")
    p.add_argument("--diffusion_model_type", type=str, default="spatial")
    p.add_argument("--object_motion_token_num", type=int, default=4)
    p.add_argument("--object_motion_token_channel", type=int, default=512)
    p.add_argument("--camera_motion_token_num", type=int, default=16)
    p.add_argument("--camera_motion_token_channel", type=int, default=16)
    p.add_argument("--motion_token_num", type=int, default=4)
    p.add_argument("--motion_token_channel", type=int, default=512)
    p.add_argument("--camera_mask_ratio", type=float, default=None)
    p.add_argument("--object_mask_ratio", type=float, default=None)
    p.add_argument("--use_mask", type=str2bool, default=False,
                   help="optical-flow camera_mask: the dataset computes it "
                        "and the model multiplies the low band by it "
                        "before the camera encoder")
    p.add_argument("--mask_video_ratio", type=float, default=0.5,
                   help="flow_mask camera-region budget")
    p.add_argument("--object_enc_num_layers", type=int, default=8)
    p.add_argument("--camera_enc_num_layers", type=int, default=8)
    p.add_argument("--enc_nhead", type=int, default=8)
    p.add_argument("--enc_ndim", type=int, default=64)
    p.add_argument("--diffusion_num_layers", type=int, default=12)
    p.add_argument("--diffusion_attn_num_heads", type=int, default=16)
    p.add_argument("--diffusion_attn_head_dim", type=int, default=64)
    p.add_argument("--image_patch_size", type=int, default=2)
    p.add_argument("--remat", type=str2bool, default=False)
    p.add_argument("--remat_policy", type=str, default="full",
                   choices=["full", "dots", "dots_sans_ffn", "dots_offload"],
                   help="what a checkpointed DiT layer keeps: full = its "
                        "inputs; dots = also the dense layers' outputs; "
                        "dots_sans_ffn = dots without the wide "
                        "up-projections; dots_offload = dots in pinned host "
                        "memory")
    p.add_argument("--scan_layers", type=str2bool, default=False,
                   help="accepted; the port's layers are unrolled")
    p.add_argument("--attn_impl", type=str, default="auto",
                   choices=["auto", "xla", "pallas", "ring"],
                   help="auto: kernels above 256^2 logits; xla: plain "
                        "attention; pallas: kernels wherever one takes the "
                        "call; ring: sequences sharded over the mesh's "
                        "tensor axis")
    # data
    p.add_argument("--dataset", type=str, default="AMDConsecutiveVideo")
    p.add_argument("--video_dir", type=str, required=True)
    p.add_argument("--sample_fps", type=int, default=8)
    p.add_argument("--sample_size", type=int, default=256)
    p.add_argument("--dataloader_num_workers", type=int, default=8)
    # vae
    p.add_argument("--vae_ckpt", type=str, default=None,
                   help="sd-vae safetensors; random weights if omitted")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda (the default) never falls back "
                        "to the CPU")
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=[None, "nccl", "gloo"],
                   help="process group backend over several ranks: nccl on "
                        "CUDA and gloo on the CPU by default")
    return p.parse_args(argv)


def mesh_shape(args):
    """``--mesh`` as a tuple, or None."""
    return tuple(int(x) for x in args.mesh.split(",")) if args.mesh \
        else None


def check_supported(args) -> None:
    """Refuse a model the trainer cannot run: ``AMDModelRec``, whose
    forward takes no timestep and no ``return_meta_info``."""
    if args.model_type not in amd_mod.AMD_MODELS:
        raise ValueError(f"--model_type {args.model_type}: one of "
                         f"{sorted(amd_mod.AMD_MODELS)}")
    if args.model_type in ("AMD_S_Rec", "AMD_S_RecSplit"):
        raise NotImplementedError(
            f"--model_type {args.model_type}: AMDModelRec has a forward and "
            "a loss only (no timestep draws, no return_meta_info), so the "
            "trainer cannot train it; the JAX package's trainer fails on it "
            "the same way")


# the widths the factories fix, which a factory build does not take from
# the flags
_FACTORY_WIDTHS = ("enc_nhead", "enc_ndim", "diffusion_attn_head_dim",
                   "diffusion_attn_num_heads", "diffusion_out_channels",
                   "diffusion_num_layers")


def build_model(args, cfg: amd_mod.AMDConfig, device):
    """The model of ``--model_type`` with fp32 weights: from
    ``--amd_config``, the class its factory builds
    (``models.amd.AMD_CLASSES``); from the flags, AMD_N, AMD_S and AMD_L
    at the flags' widths and any other name through its factory, which
    fixes its widths."""
    kw = dict(device=device, dtype=torch.float32)
    name = args.model_type
    if args.amd_config or name in ("AMD_N", "AMD_S", "AMD_L"):
        return amd_mod.AMD_CLASSES[name](cfg, **kw)
    over = {k: v for k, v in cfg.to_dict().items()
            if k not in _FACTORY_WIDTHS}
    return amd_mod.AMD_MODELS[name](**kw, **over)


def build_config(args) -> amd_mod.AMDConfig:
    """The model config of ``--amd_config``, or of the flags."""
    if args.amd_config:
        with open(args.amd_config) as f:
            return amd_mod.AMDConfig.from_dict(json.load(f))
    return amd_mod.AMDConfig(
        video_frames=args.video_frames, image_height=args.image_height,
        image_width=args.image_width, use_filter=args.use_filter,
        use_grey=args.use_grey, use_camera=args.use_camera,
        use_object=args.use_object, use_camera_down=args.use_camera_down,
        use_regularizers=args.use_regularizers,
        motion_type=args.motion_type,
        diffusion_model_type=args.diffusion_model_type,
        object_motion_token_num=args.object_motion_token_num,
        object_motion_token_channel=args.object_motion_token_channel,
        camera_motion_token_num=args.camera_motion_token_num,
        camera_motion_token_channel=args.camera_motion_token_channel,
        motion_token_num=args.motion_token_num,
        motion_token_channel=args.motion_token_channel,
        object_enc_num_layers=args.object_enc_num_layers,
        camera_enc_num_layers=args.camera_enc_num_layers,
        image_patch_size=args.image_patch_size, remat=args.remat,
        remat_policy=args.remat_policy, scan_layers=args.scan_layers,
        use_mask=args.use_mask, attn_impl=args.attn_impl,
        enc_nhead=args.enc_nhead, enc_ndim=args.enc_ndim,
        diffusion_attn_head_dim=args.diffusion_attn_head_dim,
        diffusion_attn_num_heads=args.diffusion_attn_num_heads,
        diffusion_num_layers=args.diffusion_num_layers)


def build_loader(args, cfg: amd_mod.AMDConfig,
                 mesh: Optional[mesh_lib.Mesh] = None) -> DataLoader:
    """The dataset of ``--dataset`` over ``--video_dir`` and this rank's
    loader: its share of the global ``--train_batch_size`` from its shard
    of the videos (ranks of one ``tensor`` group load the same; default:
    one rank)."""
    mesh = mesh or mesh_lib.local_mesh()
    dp = mesh.dp_size
    if args.train_batch_size % dp:
        raise ValueError(
            f"batch size {args.train_batch_size} must be divisible by the "
            f"data-parallel extent {dp} (mesh {dict(mesh.shape)})")
    dataset = DATASETS[args.dataset](
        args.video_dir, sample_n_frames=args.video_frames,
        sample_size=args.sample_size, target_fps=args.sample_fps,
        use_grey=cfg.use_grey, use_mask=cfg.use_mask,
        mask_video_ratio=args.mask_video_ratio,
        mask_latent_size=(cfg.image_height, cfg.image_width),
        mask_latent_channels=cfg.image_inchannel, seed=args.seed)
    return DataLoader(dataset, args.train_batch_size // dp,
                      num_workers=args.dataloader_num_workers,
                      seed=args.seed, shard_id=mesh.dp_index, num_shards=dp)


def train_config(args, out_dir: str) -> TrainConfig:
    return TrainConfig(
        mesh_shape=mesh_shape(args),
        output_dir=out_dir, learning_rate=args.learning_rate,
        warmup_steps=args.lr_warmup_steps, lr_schedule=args.lr_scheduler,
        weight_decay=args.adam_weight_decay,
        max_grad_norm=args.max_grad_norm, max_steps=args.max_train_steps,
        save_every=args.save_checkpoint_interval_step,
        eval_every=args.eval_interval_step,
        checkpoint_total_limit=args.checkpoint_total_limit, seed=args.seed,
        mixed_precision="no" if args.mp == "no" else "bf16",
        resume=args.resume_training,
        camera_mask_ratio=args.camera_mask_ratio,
        object_mask_ratio=args.object_mask_ratio,
        profile_steps=args.profile_steps, mu_dtype=args.mu_dtype,
        accumulate_steps=args.gradient_accumulation_steps,
        nan_policy=args.nan_policy, ema_decay=args.ema_decay,
        transfer_dtype=args.transfer_dtype)


class StdoutWriter:
    """Scalars to stdout where TensorBoard is missing; panels are
    dropped."""

    def add_scalar(self, tag, value, step):
        print(f"step {step}: {tag}={value}")

    def add_images(self, tag, images, step):
        pass

    def add_video(self, tag, video, step, fps=8):
        pass

    def close(self):
        pass


def make_writer(out_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        print(f"tensorboard does not import ({e}); logging to stdout only")
        return StdoutWriter()
    return SummaryWriter(os.path.join(out_dir, "tracker"))


def batch_stream(loader: DataLoader):
    while True:
        yield from loader


def main(argv=None) -> int:
    args = parse_args(argv)
    check_supported(args)
    cfg = build_config(args)
    device = common.start(args)
    try:
        return train(args, cfg, device)
    finally:
        common.finish()


def train(args, cfg: amd_mod.AMDConfig, device: torch.device) -> int:
    """Build the model, the VAE, this rank's loader and the trainer on the
    mesh of ``--mesh``; train, save and print the final metrics."""
    mesh = mesh_lib.create_mesh(mesh_shape(args), device_type=device.type)
    out_dir = os.path.join(args.output_dir, args.exp_name)
    os.makedirs(out_dir, exist_ok=True)
    torch.manual_seed(args.seed)
    model = build_model(args, cfg, device)
    cfg = model.cfg
    if args.pretrain_path:
        report = ckpt_lib.load_pretrain_partial(model, args.pretrain_path)
        print(f"loaded pretrain: {len(report['missing'])} missing keys")
    if mesh.is_first:
        ckpt_lib.save_config(cfg.to_dict(), out_dir)
        save_args(args, out_dir)
        print_param_num(args.model_type, model)
    vae = common.build_vae(args, device, torch.float32 if args.mp == "no"
                           else torch.bfloat16)
    vae.requires_grad_(False)

    loader = build_loader(args, cfg, mesh)
    writer = make_writer(out_dir) if mesh.is_first else None
    trainer = AMDTrainer(model, vae, train_config(args, out_dir),
                         tb_writer=writer, mesh=mesh)
    if trainer.global_step and mesh.is_first:
        print(f"resumed at step {trainer.global_step}")
    metrics = trainer.fit(batch_stream(loader))
    trainer.save()
    if mesh.is_first:
        writer.close()
        print("final metrics:", metrics)
    return 0


if __name__ == "__main__":
    sys.exit(main())
