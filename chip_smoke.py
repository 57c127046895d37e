#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hivae_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Phases (any failure exits non-zero without the final result line):

1. build the hand-written CUDA kernels from ``hivae_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) into ``hivae_tpu_torch/build/``;
2. hold each kernel against its plain PyTorch version in bf16 at the shapes
   the clip-reconstruction path gives it, plus a masked camera case with a
   fully masked key row (must give the uniform average, not NaN); time the
   kernel, the plain version and ``F.scaled_dot_product_attention`` (a
   yardstick only: the port never calls it) with CUDA events;
3. build the full-width flagship AMD_N (``configs/amd/amd_n_t1d512_spatial.json``)
   and the SD-VAE in bf16 on seeded random weights and reconstruct one
   synthetic 17 x 3 x 256 x 256 clip at ``sample_step=10`` through
   ``AMDReconstructionPipeline.sample``: one warm-up, then a timed run with
   the kernels' launch counters set to 0 just before and read just after
   (248 full-block and 3 streaming launches per clip). The decoded clip
   must be finite before quantisation, uint8 of the expected shape, and
   agree with the same clip run with the plain attention versions in
   place of the kernels;
4. print the card's name and power limit, one JSON line of per-kernel
   numbers, and as the last line the device record.

Float32 matmuls and convolutions run without TF32 here
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` both False); the model runs in bf16.
``--profile DIR`` also writes a ``torch.profiler`` table of one clip to
``DIR/profile_clip.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


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


def _bound(shape, with_bias: bool, with_lse: bool):
    """(bytes ms, operations ms): q, k, v read and o written once in bf16
    (+ the fp32 bias row, + the fp32 LSE), and the 4*B*H*Sq*Sk*D matmul
    operations of Q.K^T and P.V at the bf16 tensor-core peak."""
    b, h, s, d = shape
    nbytes = 4 * b * h * s * d * 2
    nbytes += b * s * 4 if with_bias else 0
    nbytes += b * h * s * 4 if with_lse else 0
    flops = 4 * b * h * s * s * d
    return nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3


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
                             per_clip=per_clip, max_abs_err=err, ms=ms,
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
                             per_clip=per_clip, max_abs_err=max(err, err_lse),
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
    over the clip's launch mix (launches per clip as weights); the
    per-shape numbers stay under ``cases``."""
    cases = rec.pop("cases")
    weighted = [c for c in cases if c["per_clip"] > 0]
    n = sum(c["per_clip"] for c in weighted)

    def avg(key):
        return sum(c[key] * c["per_clip"] for c in weighted) / n

    bytes_ms, ops_ms = avg("bytes_ms"), avg("ops_ms")
    rec.update(launches=launches,
               max_abs_err=max(c["max_abs_err"] for c in cases),
               ms=avg("ms"), plain_ms=avg("plain_ms"),
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               library_ms=avg("library_ms"), cases=cases)
    return rec


def synthetic_clip():
    """(17, 3, 256, 256) RGB in [-1, 1] (drifting smooth colour waves with
    seeded noise) and its grey clip (ITU-R 601 luma in all 3 channels)."""
    import numpy as np
    rng = np.random.RandomState(SEED)
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
    fa.full_block_attention.launches = 0
    fa.stream_attention.launches = 0
    t0 = time.perf_counter()
    out = clip()
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    launches = {"full_block_attention": fa.full_block_attention.launches,
                "stream_attention": fa.stream_attention.launches}
    hook.remove()

    if tuple(out.shape) != (WINDOW + 1, 3, SIZE, SIZE) or \
            out.dtype != torch.uint8:
        failures.append(f"clip: got {tuple(out.shape)} {out.dtype}")
    if not (decoded and all(bool(x) for x in decoded)):
        failures.append("clip: decoded pixels not finite before quantisation")
    if launches != {"full_block_attention": 248, "stream_attention": 3}:
        failures.append(f"clip: launches {launches}, want 248 full-block "
                        f"and 3 streaming")
    o = out.float()
    _log(f"  clip {tuple(out.shape)} {out.dtype}: mean {o.mean():.2f} std "
         f"{o.std():.2f}; latency {latency * 1e3:.2f} ms, "
         f"{WINDOW / latency:.2f} reconstructed frames/s; launches "
         f"{launches}")

    # reference: the same clip with the plain attention versions in place
    # of the kernels, on the same card and weights
    kernels = (fa.full_block_attention, fa.stream_attention)
    fa.full_block_attention = fa.full_block_attention_plain
    fa.stream_attention = fa.stream_attention_plain
    try:
        ref = clip()
    finally:
        fa.full_block_attention, fa.stream_attention = kernels
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
    failures = []
    card = _card_line()
    _log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    _log("phase 1: build")
    t0 = time.perf_counter()
    _build.build()
    _log(f"  built {', '.join(_build.KERNEL_SOURCES)} in "
         f"{time.perf_counter() - t0:.1f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  {name}: {line.strip()}")

    _log("phase 2: kernels vs plain versions (bf16)")
    records = check_kernels(fa, failures)

    _log("phase 3: full-width AMD_N + SD-VAE clip reconstruction")
    launches, _ = run_clip(fa, args, failures)

    if failures:
        _log("FAILED:\n  " + "\n  ".join(failures))
        return 1
    print(card)
    print(json.dumps({"kernels": [summarise(r, launches[r["name"]])
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
