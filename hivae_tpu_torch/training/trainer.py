"""AMD training driver (port of ``TrainConfig`` and ``AMDTrainer`` of
``hivae_tpu/training/trainer.py``).

One step, as in the JAX package: four frozen-VAE encodes outside autograd
(videos, reference frames and, with ``use_grey``, their grey versions, each
a posterior sample), the AMD training forward and its l2 loss, optionally
the perceptual leg (the VAE decode of the predicted latents with gradients
on, then LPIPS against the ground-truth frames), the backward, and the
optimizer update with the global norm of the raw gradients as ``grad_norm``.

Mixed precision. The trained parameters stay fp32 (the master weights, as
flax's fp32 ``param_dtype``); with ``mixed_precision='bf16'`` the forward
and the perceptual leg run under ``torch.autocast(dtype=torch.bfloat16)``,
so matmuls, convolutions and the attention kernels compute in bf16 while
autocast keeps norms and softmax statistics in fp32. Loss, gradients and
metrics are fp32. The frozen VAE and LPIPS run in the dtype they are given.

Randomness. Every draw of a step comes from a ``torch.Generator`` seeded
with ``(config.seed, state.step)`` (the counterpart of the JAX step's
``fold_in(rng, step)``), so a resumed run repeats the draws of the run it
continues. ``draw`` returns them as ``StepDraws``, and ``train_step`` takes
them as an input, so a caller can replay one step exactly.

Parallelism. ``mesh_shape`` (d, f, t) builds the mesh over the ranks of
the process group (``parallel.create_mesh``; None: every rank on ``data``,
one rank without a process group), or the caller passes ``mesh``. The
model is sharded (``parallel.shard_model``): its weights over ``tensor``
(Megatron column and row parallelism, ``parallel/tensor_parallel.py``)
unless the config's ``attn_impl`` is ``ring``, and over ``fsdp`` (FSDP2,
HSDP over (data, fsdp)); the config's ``attn_impl`` is installed with the
ring over ``tensor`` (``ops.attention.install_attn_impl``: a ring of one
rank warns and runs ``auto``). Each rank trains on its rows of the
global batch (the batches it is given) and draws the *global* batch's
``StepDraws`` from the step's generator, keeping its rows
(``parallel.batch_rows``), so a step at any mesh equals the one-card step
on the same global batch up to the order of reductions. Gradients are
averaged over (data, fsdp): FSDP2's reduce-scatter where sharded, else an
explicit all-reduce of the gradient list (on one rank nothing moves and
the gradients are those of ``torch.autograd.grad``, as before); the ranks
of one ``tensor`` group take the same rows, and the split layers sum
their partial products and input gradients over it. ``grad_norm`` adds
each parameter's sum of squares over the axes it is split on, once for a
replicated one. Metrics are means over the mesh; rank 0 alone logs and
writes checkpoints (the whole state, gathered;
``training/checkpoint.py``).

``TrainConfig`` keeps the JAX package's fields. ``sync_every`` is accepted
and has no effect (each step's loss is read on the host), and ``fit`` does
not read ``eval_every``, as in the JAX package: a caller runs
``validate``.
``transfer_dtype="bf16"`` sends fp32 batch arrays to the card as bf16.
``fit`` copies batch N+1 to the card (from pinned memory, non-blocking)
before it reads step N's loss on the host, so the loader's work for the
next batch overlaps the device's step. ``profile_steps`` > 0 records that
many steps from ``profile_start`` with ``torch.profiler`` into
``<output_dir>/profile`` (a Chrome trace and a table by device time).
Scalars go to a duck-typed ``tb_writer`` (``add_scalar``, ``add_images``,
``add_video``) as ``train/<key>``; ``validate`` adds image and video
panels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models import amd as amd_mod
from ..models import vae as vae_mod
from ..ops import attention as attn_ops
from ..parallel import comm
from ..parallel.mesh import Mesh, create_mesh
from ..parallel.sharding import batch_rows, local, shard_model
from . import checkpoint as ckpt_lib
from .train_state import TrainState, global_norm, make_optimizer

_ENCODED = ("videos", "ref_img", "grey_videos", "ref_grey_img")


@dataclasses.dataclass
class TrainConfig:
    output_dir: str = "exp/amd"
    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    warmup_steps: int = 0
    lr_schedule: str = "constant"
    max_grad_norm: float = 1.0
    max_steps: int = 100_000
    log_every: int = 50
    save_every: int = 2000
    eval_every: int = 2000
    checkpoint_total_limit: int = 2
    seed: int = 0
    mixed_precision: str = "bf16"          # 'bf16' | 'no'
    mesh_shape: Optional[tuple] = None
    camera_mask_ratio: Optional[float] = None
    object_mask_ratio: Optional[float] = None
    resume: bool = False
    sync_every: int = 1
    # velocity MSE + w * LPIPS(decoded rec_zj, ground-truth frames)
    perceptual_weight: float = 0.0
    profile_steps: int = 0
    profile_start: int = 5
    mu_dtype: Optional[str] = None         # 'bf16' stores Adam's mu in bf16
    accumulate_steps: int = 1
    ema_decay: float = 0.0
    transfer_dtype: str = "fp32"
    # 'none': raise on a non-finite loss; 'halt': also dump the batch to
    # <output_dir>/nan_batch_step<N>.npz first; 'skip': drop the step
    # (state kept) and count it in metrics['nan_skipped']
    nan_policy: str = "none"


@dataclasses.dataclass
class StepDraws:
    """The random draws of one step: the posterior noise of each VAE
    encode (keyed as the batch) and the model forward's draws (with the KL
    posterior noises of a dual-encoder model)."""

    posterior: Dict[str, torch.Tensor]
    model: amd_mod.TrainDraws


class AMDTrainer:
    """Trains an ``AMDModelNew`` or a dual-encoder ``AMDModel`` (fp32
    parameters) against a frozen VAE on batches of pixel clips: dicts with
    ``videos`` and ``ref_img`` (N, T, 3, H, W) in [-1, 1], plus
    ``grey_videos`` and ``ref_grey_img`` when the model's config has
    ``use_grey`` and the latent-resolution ``camera_mask`` (N, 2T, C, h, w)
    when it has ``use_mask``. As in the JAX package, the mask ratios reach
    ``AMDModelNew`` only, and an ``AMDModel`` with ``use_regularizers``
    draws its KL posterior noises each step (``KLloss`` in the metrics).
    ``AMDModelRec`` is refused: its forward takes no timestep draws and no
    ``return_meta_info``, so the JAX trainer cannot run it either."""

    def __init__(self, model, vae: vae_mod.AutoencoderKL,
                 config: TrainConfig, lpips=None, tb_writer=None,
                 mesh: Optional[Mesh] = None):
        if not isinstance(model, (amd_mod.AMDModelNew, amd_mod.AMDModel)):
            raise TypeError(
                f"AMDTrainer trains AMDModelNew or AMDModel, not "
                f"{type(model).__name__}: AMDModelRec (AMD_S_Rec, "
                f"AMD_S_RecSplit) has a forward and a loss only, without "
                f"the timestep draws and return_meta_info the step passes, "
                f"as in the JAX package's trainer")
        bad = [n for n, p in model.named_parameters()
               if p.dtype != torch.float32]
        if bad:
            raise ValueError(f"AMDTrainer trains fp32 master parameters; "
                             f"{bad[:3]} are not fp32 (build the model with "
                             f"dtype=torch.float32)")
        if config.nan_policy not in ("none", "halt", "skip"):
            raise ValueError(f"nan_policy {config.nan_policy!r}")
        if config.transfer_dtype not in ("fp32", "bf16"):
            raise ValueError(f"transfer_dtype {config.transfer_dtype!r}")
        self.model, self.vae, self.lpips, self.config = (model, vae, lpips,
                                                         config)
        self._dual = isinstance(model, amd_mod.AMDModel)
        self.tb = tb_writer
        self._profiler = None
        self.device = next(model.parameters()).device
        self.mesh = mesh or create_mesh(config.mesh_shape,
                                        device_type=self.device.type)
        self._fsdp = self.mesh.shape["fsdp"] > 1
        shard_model(model, self.mesh)
        attn_ops.install_attn_impl(model.cfg, self.mesh)
        params = dict(model.named_parameters())
        tx = make_optimizer(
            list(params.values()), config.learning_rate, config.warmup_steps,
            config.max_steps, config.lr_schedule, config.weight_decay,
            max_grad_norm=config.max_grad_norm,
            accumulate_steps=config.accumulate_steps,
            mu_dtype=torch.bfloat16 if config.mu_dtype == "bf16" else None)
        self.state = TrainState(params, tx, ema_decay=config.ema_decay)
        self.ckpt = ckpt_lib.CheckpointManager(
            os.path.join(config.output_dir, "checkpoints"),
            max_to_keep=config.checkpoint_total_limit)
        self.global_step = 0
        if config.resume and self.ckpt.latest_step() is not None:
            self.restore()

    # -- one step --------------------------------------------------------------

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the card: from pinned host memory,
        non-blocking, fp32 ones as bf16 under ``transfer_dtype="bf16"``."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, list):
                continue
            x = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
            if self.config.transfer_dtype == "bf16" and \
                    x.dtype == torch.float32:
                x = x.to(torch.bfloat16)
            if self.device.type == "cuda" and x.device.type == "cpu":
                out[k] = x.pin_memory().to(self.device, non_blocking=True)
            else:
                out[k] = x.to(self.device)
        return out

    def draw(self, batch) -> StepDraws:
        """This step's draws for the *global* batch (this rank's rows times
        the mesh's data-parallel extent), from the generator of (seed,
        state.step); ``loss_and_grads`` keeps this rank's rows."""
        cfg, mcfg = self.config, self.model.cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed * 1_000_003 + self.state.step)
        n, t, _, h, w = batch["videos"].shape
        n *= self.mesh.dp_size
        f = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        lat = (n * t, self.vae.cfg.latent_channels, h // f, w // f)
        keys = _ENCODED if mcfg.use_grey else _ENCODED[:2]
        posterior = {k: torch.randn(lat, generator=gen, device=self.device)
                     for k in keys}
        grid = (h // f, w // f)
        sites = (grid[0] // mcfg.image_patch_size) * \
            (grid[1] // mcfg.image_patch_size)

        def uniform():
            return torch.rand((), generator=gen, device=self.device)

        def perm(rows, sites):
            noise = torch.rand((rows, sites), generator=gen,
                               device=self.device)
            return torch.argsort(noise, dim=1, stable=True)

        d = amd_mod.TrainDraws()
        if self._dual:
            if mcfg.use_regularizers:
                d.object_kl, d.camera_kl = (
                    torch.randn(shape, generator=gen, device=self.device)
                    for shape in self.model.kl_shapes(n, t))
        else:
            if cfg.camera_mask_ratio is not None:
                d.camera_u = uniform()
            if cfg.object_mask_ratio is not None:
                d.object_u = uniform()
            if cfg.camera_mask_ratio is not None:
                d.camera_perm = perm(n, amd_mod.camera_sites(grid, mcfg))
            if cfg.object_mask_ratio is not None:
                d.object_perm = perm(n * 2 * t, sites)
        d.time_step = amd_mod.draw_time_steps(mcfg, n, t, gen, self.device)
        d.z0 = torch.randn(lat, generator=gen, device=self.device)
        return StepDraws(posterior, d)

    def _autocast(self):
        if self.config.mixed_precision == "bf16":
            return torch.autocast(device_type=self.device.type,
                                  dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def _rows(self, draws: StepDraws, n: int) -> StepDraws:
        """This rank's rows of the global ``draws`` for a batch of ``n``
        clips a rank (each draw's leading dim is a multiple of the global
        clip count, clip-major; the mask-ratio uniforms are shared)."""
        if self.mesh.dp_size == 1:
            return draws
        total = n * self.mesh.dp_size
        rows = batch_rows(self.mesh, total)

        def keep(x):
            if x is None or x.dim() == 0:
                return x
            k = x.shape[0] // total
            return x[rows.start * k:rows.stop * k]

        model = amd_mod.TrainDraws(**{
            f.name: keep(getattr(draws.model, f.name))
            for f in dataclasses.fields(amd_mod.TrainDraws)})
        return StepDraws({k: keep(v) for k, v in draws.posterior.items()},
                         model)

    def _reduce_grads(self, loss, params) -> List[torch.Tensor]:
        """fp32 gradients of ``loss``, averaged over the mesh's (data,
        fsdp) ranks: FSDP2's reduce-scatter under ``.backward()`` where the
        parameters are sharded, else ``torch.autograd.grad`` and (with more
        than one such rank) an all-reduce."""
        if self._fsdp:
            for p in params:
                p.grad = None
            loss.backward()
            grads = [p.grad for p in params]
            for p in params:
                p.grad = None
        else:
            grads = list(torch.autograd.grad(loss, params,
                                             allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(params, grads)]
        if not self._fsdp and self.mesh.dp_group is not None:
            # in place on the local parts (a DTensor's where the weights
            # are split over 'tensor')
            comm.average_([local(g) for g in grads], self.mesh.dp_group)
        return grads

    def loss_and_grads(self, batch, draws: StepDraws):
        """(loss_dict of fp32 scalars, fp32 grads in parameter order), each
        the mean over the mesh; ``draws`` are the global batch's."""
        draws = self._rows(draws, batch["videos"].shape[0])
        cfg = self.config
        with torch.no_grad():
            lat = {k: vae_mod.vae_encode(self.vae, batch[k],
                                         noise=draws.posterior[k]).float()
                   for k in draws.posterior}
        use_lpips = cfg.perceptual_weight > 0 and self.lpips is not None
        ratio = {}
        for name in () if self._dual else ("camera_mask_ratio",
                                            "object_mask_ratio"):
            r = getattr(cfg, name)
            ratio[name] = None if r is None else torch.tensor(
                r, dtype=torch.float32, device=self.device)
        with self._autocast():
            _, _, loss_dict = self.model(
                lat["videos"], lat["ref_img"], lat.get("grey_videos"),
                lat.get("ref_grey_img"), return_meta_info=use_lpips,
                camera_mask=(batch["camera_mask"]
                             if self.model.cfg.use_mask else None),
                draws=draws.model, **ratio)
            loss = loss_dict["loss"]
            if use_lpips:
                decoded = vae_mod.decode_latents(self.vae, loss_dict["rec_zj"])
                videos = batch["videos"]
                gt = videos.reshape((-1,) + videos.shape[2:])
                p_loss = self.lpips(decoded, gt.to(decoded.dtype)).float() \
                    .mean()
                loss = loss + cfg.perceptual_weight * p_loss
                loss_dict = {k: v for k, v in loss_dict.items()
                             if v.dim() == 0}
                loss_dict.update(lpips_loss=p_loss, loss=loss)
        grads = self._reduce_grads(loss, list(self.state.params.values()))
        return comm.average_metrics({k: v.detach().float()
                                     for k, v in loss_dict.items()},
                                    self.mesh.dp_group), grads

    def _step(self, batch, draws: Optional[StepDraws] = None
              ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch already on the card -> metrics as
        0-d tensors; the host waits on the card only under
        ``nan_policy="skip"``."""
        if draws is None:
            draws = self.draw(batch)
        metrics, grads = self.loss_and_grads(batch, draws)
        metrics["grad_norm"] = global_norm(
            grads, list(self.state.params.values()))
        if self.config.nan_policy == "skip":
            finite = bool(torch.isfinite(metrics["loss"]) &
                          torch.isfinite(metrics["grad_norm"]))
            if finite:
                self.state.apply_gradients(grads)
            metrics["nan_skipped"] = torch.tensor(0.0 if finite else 1.0)
        else:
            self.state.apply_gradients(grads)
        self.global_step += 1
        return metrics

    def train_step(self, batch, draws: Optional[StepDraws] = None
                   ) -> Dict[str, float]:
        """One optimizer step on a pixel batch -> metrics (floats)."""
        metrics = self._step(self._to_device(batch), draws)
        return {k: float(v) for k, v in metrics.items()}

    # -- loop ----------------------------------------------------------------

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=acts)
        self._profiler.__enter__()

    def _stop_profile(self) -> None:
        """Write ``<output_dir>/profile/trace.json`` and ``table.txt``
        (the ops by device time, else by host time)."""
        prof, self._profiler = self._profiler, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = os.path.join(self.config.output_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        sort = ("self_device_time_total" if self.device.type == "cuda"
                else "self_cpu_time_total")
        with open(os.path.join(out, "table.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=50))
        print(f"profiler trace written to {out}")

    def fit(self, batches: Iterable[Dict[str, np.ndarray]],
            max_steps: Optional[int] = None) -> Dict[str, float]:
        cfg = self.config
        limit = max_steps or cfg.max_steps
        last: Dict[str, float] = {}
        t0 = time.perf_counter()
        it = iter(batches)
        batch = next(it, None)
        device_batch = None if batch is None else self._to_device(batch)
        while device_batch is not None and self.global_step < limit:
            host_batch = batch
            if cfg.profile_steps and self.global_step == cfg.profile_start:
                self._start_profile()
            step_metrics = self._step(device_batch)
            # the next batch goes to the card before this step's loss is
            # read on the host
            batch = next(it, None) if self.global_step < limit else None
            device_batch = None if batch is None else self._to_device(batch)
            if cfg.profile_steps and self.global_step == \
                    cfg.profile_start + cfg.profile_steps:
                self._stop_profile()
            metrics = {k: float(v) for k, v in step_metrics.items()}
            finite = np.isfinite(metrics["loss"])
            if cfg.nan_policy == "halt" and not finite:
                os.makedirs(cfg.output_dir, exist_ok=True)
                rank = f"_rank{dist.get_rank()}" if self.mesh.size > 1 else ""
                dump = os.path.join(
                    cfg.output_dir,
                    f"nan_batch_step{self.global_step}{rank}.npz")
                np.savez(dump, **{k: np.asarray(torch.as_tensor(v).cpu())
                                  for k, v in host_batch.items()
                                  if not isinstance(v, list)})
                raise FloatingPointError(
                    f"non-finite loss {metrics['loss']} at step "
                    f"{self.global_step}; offending batch dumped to {dump}")
            if self.global_step % cfg.log_every == 0 or \
                    self.global_step >= limit:
                if cfg.nan_policy != "skip" and not finite:
                    raise FloatingPointError(
                        f"non-finite loss at step {self.global_step}: "
                        f"{metrics}")
                dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                last = dict(metrics, steps_per_sec=cfg.log_every /
                            max(dt, 1e-9))
                self._log(last)
            if self.global_step % cfg.save_every == 0:
                self.save()
        if self._profiler is not None:   # the loop ended inside the window
            self._stop_profile()
        return last

    def save(self) -> Optional[str]:
        """Write ``checkpoint-{global_step}`` (rotating old ones): the whole
        state, its sharded tensors gathered into rank 0's host memory
        (every rank takes part), written by rank 0 while the others wait at
        a barrier. Returns the path on rank 0, else None."""
        state = self.state.full_state_dict()
        path = None
        if self.mesh.is_first:
            path = self.ckpt.save(self.global_step, state)
        if self.mesh.size > 1:
            dist.barrier()
        return path

    def restore(self, path: Optional[str] = None) -> None:
        """Load the newest checkpoint (or ``path``) into the live state;
        each rank keeps its part of the whole state."""
        self.state.load_state_dict(self.ckpt.restore(
            path, map_location="cpu" if self._fsdp else self.device))
        self.global_step = self.state.step

    def _log(self, metrics: Dict[str, float]) -> None:
        if self.tb is not None and self.mesh.is_first:
            for k, v in metrics.items():
                self.tb.add_scalar(f"train/{k}", v, self.global_step)

    # -- validation ----------------------------------------------------------

    @contextlib.contextmanager
    def _eval_weights(self):
        """The model carries the EMA weights inside, where tracked. A
        sharded model is resharded on the way out: FSDP2 keeps its root's
        gathered parameters after a forward, which would carry the EMA
        weights into the next training step."""
        ema = self.state.ema_params
        parts = {k: local(p) for k, p in self.state.params.items()}
        live = None
        if ema is not None:
            live = {k: p.detach().clone() for k, p in parts.items()}
            with torch.no_grad():
                for k, p in parts.items():
                    p.copy_(ema[k])
        try:
            yield
        finally:
            if self._fsdp:
                self.model.reshard()
            if live is not None:
                with torch.no_grad():
                    for k, p in parts.items():
                        p.copy_(live[k])

    @torch.no_grad()
    def validate(self, batch, sample_step: int = 2,
                 generator: amd_mod.DrawSource = None,
                 grid_path: Optional[str] = None) -> np.ndarray:
        """Reconstruct a pixel batch: posterior-mode encodes, ``sample``
        with the EMA weights where tracked (its draws from ``generator``,
        by default a generator seeded with 0), the VAE decode; optionally
        a grid mp4 at ``grid_path`` and writer panels. Returns the decoded
        clips, uint8 (N, T, C, H, W)."""
        batch = self._to_device(batch)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        mcfg = self.model.cfg
        keys = _ENCODED if mcfg.use_grey else _ENCODED[:2]
        lat = {k: vae_mod.vae_encode(self.vae, batch[k]).float()
               for k in keys}
        kwargs = {}
        if mcfg.use_mask and "camera_mask" in batch:
            kwargs["camera_mask"] = batch["camera_mask"]
        with self._eval_weights(), self._autocast():
            _, sample_z, _ = amd_mod.sample(
                self.model, lat["videos"], lat["ref_img"],
                lat.get("grey_videos"), lat.get("ref_grey_img"),
                sample_step=sample_step, generator=generator, **kwargs)
        video = vae_mod.vae_decode(self.vae, sample_z.float())
        out = vae_mod.latents_to_rgb(video).cpu().numpy()
        if grid_path is not None:
            from ..data.video import save_videos_grid

            save_videos_grid(grid_path, out)
        if self.tb is not None:
            self.tb.add_images("val/first_frame_pred", out[:, 0],
                               self.global_step)
            gt = vae_mod.latents_to_rgb(batch["videos"]).cpu().numpy()
            self.tb.add_images("val/first_frame_gt", gt[:, 0],
                               self.global_step)
            self.tb.add_video("val/video_pred", out, self.global_step, fps=8)
        return out


def batch_from_clips(clips: List[np.ndarray],
                     grey: Optional[List[np.ndarray]] = None
                     ) -> Dict[str, np.ndarray]:
    """(T+1, 3, H, W) clips in [-1, 1] (frame 0 the reference) -> a training
    batch: ``videos`` the T target frames, ``ref_img`` frame 0 repeated T
    times, and the same for ``grey`` clips."""
    def split(cs):
        x = np.stack(cs)
        ref = np.repeat(x[:, :1], x.shape[1] - 1, axis=1)
        return np.ascontiguousarray(x[:, 1:]), np.ascontiguousarray(ref)

    batch = dict(zip(("videos", "ref_img"), split(clips)))
    if grey is not None:
        batch.update(zip(("grey_videos", "ref_grey_img"), split(grey)))
    return batch
