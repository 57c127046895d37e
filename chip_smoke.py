#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hivae_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Phases (any failure exits non-zero without the final result line):

1. build the hand-written CUDA kernels from ``hivae_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) into ``hivae_tpu_torch/build/``;
2. hold each kernel against its plain PyTorch version in bf16: the forward
   kernels at the shapes the clip-reconstruction path gives them, plus a
   masked camera case with a fully masked key row (must give the uniform
   average, not NaN); the backward kernels at every training shape for
   N = 4 and N = 1 clips, plus masked cases. Each kernel, its plain
   version and one PyTorch call that computes the same function (a
   yardstick only: the port never calls it; for a backward, the time of
   ``F.scaled_dot_product_attention`` forward plus backward minus its
   forward) are timed with CUDA events;
3. build the full-width flagship AMD_N (``configs/amd/amd_n_t1d512_spatial.json``)
   and the SD-VAE in bf16 on seeded random weights and reconstruct one
   synthetic 17 x 3 x 256 x 256 clip at ``sample_step=10`` through
   ``AMDReconstructionPipeline.sample``: one warm-up, then a timed run with
   the kernels' launch counters set to 0 just before and read just after
   (248 full-block and 3 streaming launches per clip). The decoded clip
   must be finite before quantisation, uint8 of the expected shape, and
   agree with the same clip run with the plain attention versions in
   place of the kernels;
4. training run A, the flagship script's settings on one card: AMD_N with
   fp32 master weights and bf16 compute, remat ``full``, AdamW (lr 1e-4,
   decay 1e-2, clip 1.0, bf16 first moment) on N = 4 synthetic clips with
   the MSE loss; one warm-up step, then 3 timed steps with exact launch
   counts; finite loss and grad_norm, parameters that moved, and one step
   with the plain attention versions in place of the kernels from the same
   state, batch and draws (loss and gradient against the kernel step);
5. training run B: N = 1 with the perceptual loss (weight 0.5, seeded
   random LPIPS weights) and both mask ratios at 0.5, one warm-up step and
   2 timed steps with exact launch counts (now with the streaming backward
   kernels), the same plain-step check, then a checkpoint save, a resume
   in a new trainer, and one more step from each that must agree bit for
   bit;
6. print the card's name and power limit, one JSON line of per-kernel
   numbers, and as the last line the device record.

Float32 matmuls and convolutions run without TF32 here
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` both False), and cuDNN picks
deterministic algorithms. ``--profile DIR`` also writes a
``torch.profiler`` table of one clip to ``DIR/profile_clip.txt`` and of one
run-A training step to ``DIR/profile_train.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import math
import re
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "amd", "amd_n_t1d512_spatial.json")
SEED = 0
WINDOW = 16
SIZE = 256
SAMPLE_STEP = 10

# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

KERNEL_ATOL = 2e-2   # bf16 outputs of unit scale: P rounded at other points
LSE_ATOL = 1e-3      # fp32 LSE, sums in another order
# The kernel path and the plain path round P to bf16 at different points of
# each softmax; over 10 Euler steps of a random-weight model that may move a
# decoded pixel by a few uint8 levels. Mean |diff| stays well below one.
CLIP_MEAN_ATOL = 1.0
CLIP_P99_ATOL = 8

# (name, q shape, launches per clip at sample_step=10)
FULL_BLOCK_CASES = [
    ("object encoder", (32, 8, 260, 64), 8),
    ("DiT object joint", (16, 16, 266, 64), 12 * SAMPLE_STEP),
    ("DiT camera joint", (16, 16, 512, 64), 12 * SAMPLE_STEP),
]
STREAM_CASES = [("SD-VAE mid-block", (17, 1, 1024, 512), 3)]

# training: clips per step in runs A and B, timed steps, frames per clip
RUN_A_CLIPS, RUN_A_STEPS = 4, 3
RUN_B_CLIPS, RUN_B_STEPS = 1, 2
# Gradients of bf16 attention, held relative to their largest element: both
# sides round P and dS to bf16 from sums taken in another order, and the
# full-block kernel takes delta = rowsum(dO * O) from the bf16 output where
# its plain version takes rowsum(dP * P) in fp32.
BWD_RTOL = 2e-2
# A training step with the kernels against the same step with the plain
# attention versions, from the same state, batch and draws. The two differ
# only by where bf16 rounds inside ~120 attentions of a random-weight
# model; over one step that moves the fp32 loss by well under 1% and
# leaves the 696 M-element gradient pointing the same way.
STEP_LOSS_RTOL = 1e-2
STEP_GRAD_COS = 0.99


def full_block_bwd_cases(clips):
    """(label, q shape, launches per training step) at N clips of 16
    frames: 8 object-encoder layers over 2T frames, 12 DiT layers with an
    object and a camera joint block."""
    nt = clips * WINDOW
    return [(f"object encoder N={clips}", (2 * nt, 8, 260, 64), 8),
            (f"DiT object joint N={clips}", (nt, 16, 266, 64), 12),
            (f"DiT camera joint N={clips}", (nt, 16, 512, 64), 12)]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _ptxas_summary(log: str):
    """One line per compiled kernel from ``nvcc -Xptxas -v`` output:
    kernel<D>, registers, spills."""
    kernel, spill = "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN2hv(\d+)(\w+)'", line)
        if m:
            d = re.search(r"ILi(\d+)E", m.group(2))
            kernel = m.group(2)[:int(m.group(1))] + (f"<{d.group(1)}>" if d
                                                      else "")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            yield (f"{kernel}: {regs.group(1) if regs else '?'} registers, "
                   f"{spill}")


def _time_ms(fn, iters: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(shape, with_bias: bool, with_lse: bool, tensors: int = 4,
           stats: int = 0, flop_factor: int = 4):
    """(bytes ms, operations ms) of one attention call at the card's peaks.
    Bytes: ``tensors`` (B, H, S, D) bf16 tensors each read or written once
    (forward: q, k, v, o), the fp32 bias row, the fp32 LSE and ``stats``
    more fp32 (B, H, S) rows. Operations: ``flop_factor``*B*H*Sq*Sk*D matmul
    flops (forward: 4, Q.K^T and P.V) at the bf16 tensor-core peak."""
    b, h, s, d = shape
    nbytes = tensors * b * h * s * d * 2
    nbytes += b * s * 4 if with_bias else 0
    nbytes += b * h * s * 4 * ((1 if with_lse else 0) + stats)
    flops = flop_factor * b * h * s * s * d
    return nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3


def _library_bwd_ms(q, k, v, do, mask, scale, iters):
    """F.scaled_dot_product_attention forward + backward minus forward."""
    import torch
    import torch.nn.functional as F
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                             scale=scale)
        torch.autograd.grad(out, (qg, kg, vg), do)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                           scale=scale)
    return _time_ms(fwd_bwd, iters) - _time_ms(fwd, iters)


def _abs_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _rel_err(got, want):
    return _abs_err(got, want) / want.float().abs().max().item()


def check_bwd_kernels(fa, failures):
    """Phase 2, backward kernels. Returns the per-kernel records."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def masked_bias(b, s, full_row=True):
        keep = torch.rand((b, s), generator=gen, device="cuda") > 0.3
        keep[:, 0] = True
        if full_row:
            keep[0] = False   # one fully masked row
        return torch.where(keep, 0.0, -1e30).to(torch.float32)

    cases = []
    for clips in (RUN_A_CLIPS, RUN_B_CLIPS):
        cases += [(label, shape, per_step, clips)
                  for label, shape, per_step in full_block_bwd_cases(clips)]
    cases += [("object encoder N=1, masked", (32, 8, 260, 64), 0, 0),
              ("DiT camera joint N=1, masked", (16, 16, 512, 64), 0, 0)]
    fb = []
    for label, shape, per_step, clips in cases:
        q, k, v, do = (rand(shape) for _ in range(4))
        scale = shape[3] ** -0.5
        bias = masked_bias(shape[0], shape[2]) if per_step == 0 else None
        out, m, l = fa._full_block_fwd(q, k, v, bias, scale, stats=True)
        got = fa.full_block_attention_bwd(q, k, v, do, out, m, l,
                                          scale=scale, bias=bias)
        want = fa.full_block_attention_bwd_plain(q, k, v, do, scale=scale,
                                                 bias=bias)
        torch.cuda.synchronize()
        errs = [_rel_err(g, w) for g, w in zip(got, want)]
        abs_err = max(_abs_err(g, w) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        if not (finite and max(errs) <= BWD_RTOL):
            failures.append(f"full_block_bwd {label}: rel err dq/dk/dv "
                            f"{errs} finite {finite}")
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        ms = _time_ms(lambda: fa.full_block_attention_bwd(
            q, k, v, do, out, m, l, scale=scale, bias=bias), 20)
        plain_ms = _time_ms(lambda: fa.full_block_attention_bwd_plain(
            q, k, v, do, scale=scale, bias=bias), 5)
        lib_ms = _library_bwd_ms(q, k, v, do, mask, scale, 20)
        bytes_ms, ops_ms = _bound(shape, bias is not None, False, tensors=7,
                                  stats=3, flop_factor=10)
        fb.append(dict(label=label, shape=list(shape), clips=clips,
                       per_step=per_step,
                       weight=per_step if clips == RUN_A_CLIPS else 0,
                       max_abs_err=abs_err, max_rel_err=max(errs), ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       bytes_ms=bytes_ms, ops_ms=ops_ms,
                       err_dq_dk_dv=errs))
        _log(f"  full_block_bwd {label} {shape}: rel err dq {errs[0]:.3g} "
             f"dk {errs[1]:.3g} dv {errs[2]:.3g}  kernel {ms:.4f} ms  plain "
             f"{plain_ms:.4f} ms  sdpa bwd {lib_ms:.4f} ms  bound "
             f"{max(bytes_ms, ops_ms):.4f} ms")

    dq_cases, dkv_cases = [], []
    for label, shape, per_step, clips in [
            ("SD-VAE decoder mid-block N=1", (16, 1, 1024, 512), 1,
             RUN_B_CLIPS),
            ("SD-VAE mid-block, masked", (4, 1, 1024, 512), 0, 0)]:
        q, k, v, do = (rand(shape) for _ in range(4))
        scale = shape[3] ** -0.5
        bias = None
        if per_step == 0:
            # a masked key row and a fully masked key block, in rows that
            # attend to some key: the streaming backward takes P from the
            # LSE, as the TPU kernels do, and a row with no key to attend
            # to has no LSE that keeps its 1/l at -1e30
            bias = masked_bias(shape[0], shape[2], full_row=False)
            bias[:, 64:96] = -1e30
        out, lse = fa.stream_attention(q, k, v, scale=scale, bias=bias)
        delta = (do.float() * out.float()).sum(-1)
        dq = fa.stream_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale,
                                        bias=bias)
        dk, dv = fa.stream_attention_bwd_dkv(q, k, v, do, lse, delta,
                                             scale=scale, bias=bias)
        want = fa.stream_attention_bwd_plain(q, k, v, do, out, lse,
                                             scale=scale, bias=bias)
        torch.cuda.synchronize()
        errs = [_rel_err(g, w) for g, w in zip((dq, dk, dv), want)]
        abs_errs = [_abs_err(g, w) for g, w in zip((dq, dk, dv), want)]
        finite = all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
        if not (finite and max(errs) <= BWD_RTOL):
            failures.append(f"stream_bwd {label}: rel err dq/dk/dv {errs} "
                            f"finite {finite}")
        if bias is not None and max(dk[:, :, 64:96].abs().max().item(),
                                    dv[:, :, 64:96].abs().max().item()) != 0:
            failures.append(f"stream_bwd {label}: a fully masked key block "
                            f"got a gradient")
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        dq_ms = _time_ms(lambda: fa.stream_attention_bwd_dq(
            q, k, v, do, lse, delta, scale=scale, bias=bias), 10)
        dkv_ms = _time_ms(lambda: fa.stream_attention_bwd_dkv(
            q, k, v, do, lse, delta, scale=scale, bias=bias), 10)
        plain_ms = _time_ms(lambda: fa.stream_attention_bwd_plain(
            q, k, v, do, out, lse, scale=scale, bias=bias), 5)
        lib_ms = _library_bwd_ms(q, k, v, do, mask, scale, 10)
        common = dict(label=label, shape=list(shape), clips=clips,
                      per_step=per_step, weight=per_step, plain_ms=plain_ms,
                      library_ms=lib_ms)
        b_ms, o_ms = _bound(shape, bias is not None, True, tensors=5,
                            stats=1, flop_factor=6)
        dq_cases.append(dict(common, max_abs_err=abs_errs[0],
                             max_rel_err=errs[0], ms=dq_ms, bytes_ms=b_ms,
                             ops_ms=o_ms))
        b_ms2, o_ms2 = _bound(shape, bias is not None, True, tensors=6,
                              stats=1, flop_factor=8)
        dkv_cases.append(dict(common, max_abs_err=max(abs_errs[1:]),
                              max_rel_err=max(errs[1:]), ms=dkv_ms,
                              bytes_ms=b_ms2, ops_ms=o_ms2))
        _log(f"  stream_bwd {label} {shape}: rel err dq {errs[0]:.3g} dk "
             f"{errs[1]:.3g} dv {errs[2]:.3g}  dq kernel {dq_ms:.4f} ms "
             f"(bound {max(b_ms, o_ms):.4f})  dkv kernel {dkv_ms:.4f} ms "
             f"(bound {max(b_ms2, o_ms2):.4f})  plain {plain_ms:.4f} ms  "
             f"sdpa bwd {lib_ms:.4f} ms")

    src = "hivae_tpu_torch/csrc/"
    tpu = "hivae_tpu/ops/pallas/flash_attention.py:"

    def record(name, source, line, cs):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": tpu + line, "cases": cs}
    return [record("full_block_attention_bwd", "flash_full_block_bwd.cu",
                   "188", fb),
            record("stream_attention_bwd_dq", "flash_stream_bwd.cu", "512",
                   dq_cases),
            record("stream_attention_bwd_dkv", "flash_stream_bwd.cu", "552",
                   dkv_cases)]


def check_kernels(fa, failures):
    """Phase 2. Returns the per-kernel records (before launches)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def qkv(shape):
        return [torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(3)]

    def record(name, src, replaces, cases):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "cases": cases}

    fb_cases = []
    for label, shape, per_clip in FULL_BLOCK_CASES + [
            ("DiT camera joint, masked", (16, 16, 512, 64), 0)]:
        q, k, v = qkv(shape)
        scale = shape[3] ** -0.5
        bias = None
        if per_clip == 0:
            keep = torch.rand((shape[0], shape[2]), generator=gen,
                              device="cuda") > 0.3
            keep[0] = False   # one fully masked row
            bias = torch.where(keep, 0.0, -1e30).to(torch.float32)
        got = fa.full_block_attention(q, k, v, scale=scale, bias=bias)
        want = fa.full_block_attention_plain(q, k, v, scale=scale, bias=bias)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        if per_clip == 0:
            uniform = v[0].float().mean(dim=1, keepdim=True)
            err_u = (got[0].float() - uniform).abs().max().item()
            _log(f"  {label}: fully masked row vs uniform average "
                 f"max|err| {err_u:.3g}")
            if not err_u <= KERNEL_ATOL:
                failures.append(f"full_block {label}: masked row not uniform "
                                f"({err_u})")
        if not (finite and err <= KERNEL_ATOL):
            failures.append(f"full_block {shape}: max|err| {err} finite "
                            f"{finite}")
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        iters = 50
        ms = _time_ms(lambda: fa.full_block_attention(q, k, v, scale=scale,
                                                      bias=bias), iters)
        plain_ms = _time_ms(lambda: fa.full_block_attention_plain(
            q, k, v, scale=scale, bias=bias), 10)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), iters)
        bytes_ms, ops_ms = _bound(shape, bias is not None, False)
        fb_cases.append(dict(label=label, shape=list(shape),
                             per_clip=per_clip, weight=per_clip,
                             max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bytes_ms=bytes_ms, ops_ms=ops_ms))
        _log(f"  full_block {label} {shape}: max|err| {err:.3g}  kernel "
             f"{ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  "
             f"bound {max(bytes_ms, ops_ms):.4f} ms")

    st_cases = []
    for label, shape, per_clip in STREAM_CASES:
        q, k, v = qkv(shape)
        scale = shape[3] ** -0.5
        out, lse = fa.stream_attention(q, k, v, scale=scale)
        wo, wl = fa.stream_attention_plain(q, k, v, scale=scale)
        torch.cuda.synchronize()
        err = (out.float() - wo.float()).abs().max().item()
        err_lse = (lse - wl).abs().max().item()
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        if not (finite and err <= KERNEL_ATOL and err_lse <= LSE_ATOL):
            failures.append(f"stream {shape}: max|err| {err} lse {err_lse} "
                            f"finite {finite}")
        ms = _time_ms(lambda: fa.stream_attention(q, k, v, scale=scale), 20)
        plain_ms = _time_ms(lambda: fa.stream_attention_plain(
            q, k, v, scale=scale), 10)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 20)
        bytes_ms, ops_ms = _bound(shape, False, True)
        st_cases.append(dict(label=label, shape=list(shape),
                             per_clip=per_clip, weight=per_clip,
                             max_abs_err=max(err, err_lse),
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bytes_ms=bytes_ms, ops_ms=ops_ms))
        _log(f"  stream {label} {shape}: max|err| O {err:.3g} LSE "
             f"{err_lse:.3g}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
             f"sdpa {lib_ms:.4f} ms  bound {max(bytes_ms, ops_ms):.4f} ms")

    return [
        record("full_block_attention",
               "hivae_tpu_torch/csrc/flash_full_block.cu",
               "hivae_tpu/ops/pallas/flash_attention.py:167", fb_cases),
        record("stream_attention", "hivae_tpu_torch/csrc/flash_stream.cu",
               "hivae_tpu/ops/pallas/flash_attention.py:468", st_cases),
    ]


def summarise(rec, launches):
    """One kernel's line entry. Times and bounds are per launch, averaged
    over the launch mix of the path the kernel's weights describe (the clip
    for the forward kernels, training run A for the full-block backward,
    run B for the streaming backward); the per-shape numbers stay under
    ``cases``. ``launches`` is the sum over the timed paths, which are
    listed per path under ``launches_per_path``."""
    cases = rec.pop("cases")
    weighted = [c for c in cases if c["weight"] > 0]
    n = sum(c["weight"] for c in weighted)

    def avg(key):
        return sum(c[key] * c["weight"] for c in weighted) / n

    bytes_ms, ops_ms = avg("bytes_ms"), avg("ops_ms")
    rec.update(launches=sum(launches.values()),
               launches_per_path=launches,
               max_abs_err=max(c["max_abs_err"] for c in cases),
               ms=avg("ms"), plain_ms=avg("plain_ms"),
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               library_ms=avg("library_ms"), cases=cases)
    return rec


def synthetic_clip(seed: int = SEED):
    """(17, 3, 256, 256) RGB in [-1, 1] (drifting smooth colour waves with
    seeded noise) and its grey clip (ITU-R 601 luma in all 3 channels)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, SIZE), np.linspace(0, 1, SIZE),
                         indexing="ij")
    frames = []
    for t in range(WINDOW + 1):
        chans = [np.sin(2 * np.pi * (f * xx + g * yy) + 0.3 * t + ph)
                 for f, g, ph in rng.uniform(0.5, 3.0, (3, 3))]
        frames.append(np.stack(chans))
    rgb = np.stack(frames) * 0.8 + 0.1 * rng.randn(WINDOW + 1, 3, SIZE, SIZE)
    rgb = np.clip(rgb, -1, 1).astype(np.float32)
    luma = np.tensordot(np.array([0.299, 0.587, 0.114], np.float32), rgb,
                        axes=([0], [1]))
    grey = np.repeat(luma[:, None], 3, axis=1).astype(np.float32)
    return rgb, grey


def run_clip(fa, args, failures):
    """Phase 3. Returns (launches per kernel name, latency s)."""
    import torch
    from hivae_tpu_torch.models import amd as amd_mod
    from hivae_tpu_torch.models import vae as vae_mod
    from hivae_tpu_torch.pipelines import AMDReconstructionPipeline

    with open(CONFIG) as f:
        cfg = amd_mod.AMDConfig.from_dict(json.load(f))
    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    amd = amd_mod.AMDModelNew(cfg, device="cuda", dtype=torch.bfloat16).eval()
    vae = vae_mod.AutoencoderKL(vae_mod.VAEConfig(), device="cuda",
                                dtype=torch.bfloat16).eval()
    n_amd = sum(p.numel() for p in amd.parameters())
    n_vae = sum(p.numel() for p in vae.parameters())
    _log(f"  AMD_N {n_amd / 1e6:.1f} M params, SD-VAE {n_vae / 1e6:.1f} M, "
         f"bf16, built in {time.perf_counter() - t0:.1f} s")

    rgb, grey = synthetic_clip()
    pixels = torch.from_numpy(rgb).cuda()
    grey = torch.from_numpy(grey).cuda()
    pipe = AMDReconstructionPipeline(vae, amd, window=WINDOW)

    # finiteness of the decoded pixels before quantisation, observed from
    # outside the port: the decoder's last conv output
    decoded = []
    hook = vae.decoder.conv_out.register_forward_hook(
        lambda _m, _i, out: decoded.append(torch.isfinite(out).all()))

    def clip():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        return pipe.sample(pixels, grey, video_sample_step=SAMPLE_STEP,
                           generator=gen)

    clip()  # warm-up
    torch.cuda.synchronize()
    decoded.clear()
    _zero_counts(fa)
    t0 = time.perf_counter()
    out = clip()
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    launches = _read_counts(fa)
    hook.remove()

    if tuple(out.shape) != (WINDOW + 1, 3, SIZE, SIZE) or \
            out.dtype != torch.uint8:
        failures.append(f"clip: got {tuple(out.shape)} {out.dtype}")
    if not (decoded and all(bool(x) for x in decoded)):
        failures.append("clip: decoded pixels not finite before quantisation")
    if launches != dict(_no_launches(), full_block_attention=248,
                        stream_attention=3):
        failures.append(f"clip: launches {launches}, want 248 full-block "
                        f"and 3 streaming")
    o = out.float()
    _log(f"  clip {tuple(out.shape)} {out.dtype}: mean {o.mean():.2f} std "
         f"{o.std():.2f}; latency {latency * 1e3:.2f} ms, "
         f"{WINDOW / latency:.2f} reconstructed frames/s; launches "
         f"{launches}")

    # reference: the same clip with the plain attention versions in place
    # of the kernels, on the same card and weights
    with _plain_attention(fa):
        ref = clip()
    diff = (out.int() - ref.int()).abs().float()
    mean_d = diff.mean().item()
    p99 = torch.quantile(diff.flatten(), 0.99).item()
    _log(f"  clip vs plain-attention clip: mean|diff| {mean_d:.4f} levels, "
         f"p99 {p99:.0f}, max {diff.max().item():.0f}")
    if not (mean_d <= CLIP_MEAN_ATOL and p99 <= CLIP_P99_ATOL):
        failures.append(f"clip vs plain: mean {mean_d} p99 {p99}")

    if args.profile:
        profile_clip(pipe, clip, args.profile)
    return launches, latency


COUNTERS = ("full_block_attention", "full_block_attention_bwd",
            "stream_attention", "stream_attention_bwd_dq",
            "stream_attention_bwd_dkv")


def _no_launches():
    return {name: 0 for name in COUNTERS}


def _zero_counts(fa):
    for name in COUNTERS:
        getattr(fa, name).launches = 0


def _read_counts(fa):
    return {name: getattr(fa, name).launches for name in COUNTERS}


class _plain_attention:
    """The plain attention versions in place of the kernels (the sdpa
    dispatch calls them through the module), for a reference run."""

    def __init__(self, fa):
        self.fa = fa

    def __enter__(self):
        fa = self.fa
        self.kernels = (fa.full_block_attention, fa.stream_attention)
        fa.full_block_attention = fa.full_block_attention_plain
        fa.stream_attention = fa.stream_attention_plain

    def __exit__(self, *exc):
        self.fa.full_block_attention, self.fa.stream_attention = self.kernels


def build_training_models():
    """Full-width AMD_N with fp32 master weights (remat on, from the JSON),
    the SD-VAE in bf16 (frozen) and LPIPS (fp32, frozen), seeded random
    weights."""
    import torch
    from hivae_tpu_torch.losses.lpips import LPIPS
    from hivae_tpu_torch.models import amd as amd_mod
    from hivae_tpu_torch.models import vae as vae_mod

    with open(CONFIG) as f:
        cfg = amd_mod.AMDConfig.from_dict(json.load(f))
    torch.manual_seed(SEED + 2)
    amd = amd_mod.AMDModelNew(cfg, device="cuda", dtype=torch.float32)
    vae = vae_mod.AutoencoderKL(vae_mod.VAEConfig(), device="cuda",
                                dtype=torch.bfloat16).eval()
    lpips = LPIPS().cuda().eval()
    for mod in (vae, lpips):
        mod.requires_grad_(False)
    return amd, vae, lpips


def _expected_step_launches(cfg, perceptual: bool):
    """Kernel launches of one training step of the flagship: the object
    encoder's layers and the DiT's two joint blocks per layer run the
    full-block kernels, the DiT's forward twice under remat; each of the 4
    VAE encodes runs one streaming forward, and the perceptual leg's decode
    one more streaming forward and its two backward kernels."""
    enc, dit = cfg.object_enc_num_layers, 2 * cfg.diffusion_num_layers
    return dict(full_block_attention=enc + dit * (2 if cfg.remat else 1),
                full_block_attention_bwd=enc + dit,
                stream_attention=4 + int(perceptual),
                stream_attention_bwd_dq=int(perceptual),
                stream_attention_bwd_dkv=int(perceptual))


def run_training(fa, models, failures, *, label, clips, steps,
                 perceptual=False, mask_ratio=None, resume_check=False,
                 profile_dir=None):
    """Phases 4 and 5. Returns (launches in the timed steps, step ms)."""
    import dataclasses
    import shutil
    import torch
    from hivae_tpu_torch.training.trainer import (AMDTrainer, TrainConfig,
                                                  batch_from_clips)

    amd, vae, lpips = models
    ckpt_dir = os.path.join(ROOT, "hivae_tpu_torch", "build",
                            "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tc = TrainConfig(output_dir=ckpt_dir, learning_rate=1e-4,
                     weight_decay=1e-2, max_grad_norm=1.0,
                     mixed_precision="bf16", mu_dtype="bf16", seed=SEED,
                     perceptual_weight=0.5 if perceptual else 0.0,
                     camera_mask_ratio=mask_ratio,
                     object_mask_ratio=mask_ratio, checkpoint_total_limit=1)
    trainer = AMDTrainer(amd, vae, tc, lpips=lpips if perceptual else None)
    pairs = [synthetic_clip(SEED + 10 + i) for i in range(clips)]
    batch = trainer._to_device(batch_from_clips([p[0] for p in pairs],
                                                [p[1] for p in pairs]))
    params = list(trainer.state.params.values())

    t0 = time.perf_counter()
    trainer.train_step(batch)   # warm-up
    torch.cuda.synchronize()
    _log(f"  {label}: warm-up step {time.perf_counter() - t0:.2f} s")
    before = [p.detach().clone() for p in params]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa)
    t0 = time.perf_counter()
    metrics = [trainer.train_step(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = _read_counts(fa)
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * steps for k, v in
            _expected_step_launches(amd.cfg, perceptual).items()}
    if launches != want:
        failures.append(f"{label}: launches {launches}, want {want}")
    for m in metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            failures.append(f"{label}: non-finite metrics {m}")
    moved = sum(bool((p.detach() != b).any()) for p, b in zip(params, before))
    if moved != len(params):
        failures.append(f"{label}: {len(params) - moved} of {len(params)} "
                        f"parameter tensors did not change")
    del before
    frames = clips * WINDOW
    _log(f"  {label}: {steps} steps, losses "
         f"{[round(m['loss'], 5) for m in metrics]}, grad_norm "
         f"{[round(m['grad_norm'], 4) for m in metrics]}; step "
         f"{step_s * 1e3:.2f} ms, {clips / step_s:.3f} clips/s, "
         f"{frames / step_s:.2f} frames/s, peak memory "
         f"{peak / 2**30:.2f} GiB; {moved} parameter tensors moved; "
         f"launches {launches}")
    _log(f"  {label}: metrics of the last step {metrics[-1]}")

    # the same step with the plain attention versions, from the same state,
    # batch and draws
    draws = trainer.draw(batch)
    mk, gk = trainer.loss_and_grads(batch, draws)
    with _plain_attention(fa):
        mp, gp = trainer.loss_and_grads(batch, draws)
    rel = abs(mk["loss"].item() - mp["loss"].item()) / abs(mp["loss"].item())
    dot = sum((a * b).sum() for a, b in zip(gk, gp)).item()
    nk = sum(a.square().sum() for a in gk).item() ** 0.5
    npl = sum(b.square().sum() for b in gp).item() ** 0.5
    cos = dot / (nk * npl)
    del gk, gp
    _log(f"  {label}: kernel step vs plain-attention step: loss "
         f"{mk['loss'].item():.6f} vs {mp['loss'].item():.6f} (rel "
         f"{rel:.3g}), grad norm {nk:.5f} vs {npl:.5f}, cosine {cos:.6f}")
    if not (rel <= STEP_LOSS_RTOL and cos >= STEP_GRAD_COS):
        failures.append(f"{label}: kernel vs plain step: loss rel {rel}, "
                        f"gradient cosine {cos}")

    if profile_dir:
        profile_step(trainer, batch, profile_dir)

    if resume_check:
        t0 = time.perf_counter()
        path = trainer.save()
        save_s = time.perf_counter() - t0
        trainer.train_step(batch)
        live = [p.detach().clone() for p in params]
        live_step = trainer.global_step
        del trainer
        t0 = time.perf_counter()
        resumed = AMDTrainer(amd, vae, dataclasses.replace(tc, resume=True),
                             lpips=lpips if perceptual else None)
        load_s = time.perf_counter() - t0
        if resumed.global_step != live_step - 1:
            failures.append(f"{label}: resumed at step {resumed.global_step},"
                            f" want {live_step - 1}")
        resumed.train_step(batch)
        diff = max((p.detach() - q).abs().max().item()
                   for p, q in zip(resumed.state.params.values(), live))
        _log(f"  {label}: checkpoint {os.path.basename(path)} saved in "
             f"{save_s:.1f} s, resumed in {load_s:.1f} s; one more step from "
             f"each: max |param diff| {diff}")
        if diff != 0:
            failures.append(f"{label}: resumed step differs from the live "
                            f"step by {diff}")
        del live, resumed
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches, step_s * 1e3


def profile_step(trainer, batch, out_dir):
    """One training step under torch.profiler: the kernel table by device
    time and the device's busy share of the step's wall time, written to
    DIR/profile_train.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    line = (f"profiled training step wall {wall * 1e3:.2f} ms, device busy "
            f"{busy_us / 1e3:.2f} ms ({100 * busy_us / 1e6 / wall:.1f}%)")
    _log("  " + line)
    path = os.path.join(out_dir, "profile_train.txt")
    with open(path, "w") as f:
        f.write(f"card: {_card_line()}\n{line}\n\n")
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=50))
    _log(f"  profile written to {path}")


def profile_clip(pipe, clip, out_dir):
    """Five timed clips (the spread of the latency), the stream time spent
    in each stage's module (CUDA events at its forward hooks), and one clip
    under torch.profiler: the kernel table by device time and the device's
    busy share of the clip's wall time. Written to DIR/profile_clip.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    lines = [f"card: {_card_line()}"]

    lat = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lines.append("clip latency ms, 5 runs: " +
                 " ".join(f"{x:.2f}" for x in lat))

    stages = {"vae.encoder (RGB + grey)": pipe.vae.encoder,
              "object motion encoder": pipe.amd.object_motion_encoder,
              "camera motion encoder": pipe.amd.camera_motion_encoder,
              "velocity DiT (10 steps)": pipe.amd.diffusion_transformer,
              "vae.decoder": pipe.vae.decoder}
    spans = {name: [] for name in stages}
    handles = []
    for name, mod in stages.items():
        def pre(_m, _i, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[name].append([ev, None])

        def post(_m, _i, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[name][-1][1] = ev
        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clip()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for h in handles:
        h.remove()
    lines.append(f"stage spans (stream time between module entry and exit) "
                 f"in a {wall:.2f} ms clip:")
    for name, evs in spans.items():
        ms = sum(a.elapsed_time(b) for a, b in evs)
        lines.append(f"  {name}: {ms:.2f} ms over {len(evs)} calls "
                     f"({100 * ms / wall:.1f}%)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clip()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    lines.append(f"profiled clip wall {wall * 1e3:.2f} ms, device busy "
                 f"{busy_us / 1e3:.2f} ms ({100 * busy_us / 1e6 / wall:.1f}%)")
    for line in lines:
        _log("  " + line)
    path = os.path.join(out_dir, "profile_clip.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n\n")
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=40))
    _log(f"  profile written to {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one clip and write the table here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        _log("chip_smoke: no CUDA device; this script runs on an NVIDIA card")
        return 2
    sys.path.insert(0, ROOT)
    from hivae_tpu_torch.ops.kernels import _build
    from hivae_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    start = time.perf_counter()
    failures = []
    card = _card_line()
    _log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    _log("phase 1: build")
    t0 = time.perf_counter()
    _build.build()
    _log(f"  built {', '.join(_build.KERNEL_SOURCES)} in "
         f"{time.perf_counter() - t0:.1f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in _ptxas_summary(log):
            _log(f"  {name}: {line}")

    _log("phase 2: kernels vs plain versions (bf16)")
    records = check_kernels(fa, failures) + check_bwd_kernels(fa, failures)

    _log("phase 3: full-width AMD_N + SD-VAE clip reconstruction")
    paths = {"clip": run_clip(fa, args, failures)[0]}
    torch.cuda.empty_cache()

    _log(f"phase 4: training run A, N={RUN_A_CLIPS}, MSE loss")
    models = build_training_models()
    paths["train_A"], _ = run_training(
        fa, models, failures, label="run A", clips=RUN_A_CLIPS,
        steps=RUN_A_STEPS, profile_dir=args.profile)
    torch.cuda.empty_cache()

    _log(f"phase 5: training run B, N={RUN_B_CLIPS}, perceptual loss, "
         f"mask ratios 0.5")
    paths["train_B"], _ = run_training(
        fa, models, failures, label="run B", clips=RUN_B_CLIPS,
        steps=RUN_B_STEPS, perceptual=True, mask_ratio=0.5,
        resume_check=True)
    del models
    torch.cuda.empty_cache()

    for rec in records:
        if not any(p[rec["name"]] for p in paths.values()):
            failures.append(f"{rec['name']}: launched by no timed path")
    _log(f"total {time.perf_counter() - start:.1f} s")
    if failures:
        _log("FAILED:\n  " + "\n  ".join(failures))
        return 1
    print(card)
    print(json.dumps({"kernels": [
        summarise(r, {path: counts[r["name"]]
                      for path, counts in paths.items()})
        for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
