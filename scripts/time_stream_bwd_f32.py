"""Time the fp32 streaming dQ and dK/dV kernels of this checkout and of other
checkouts (the parent commit unpacked with ``git archive``, or a copy of
this tree with one edit) in turns, on one card, in one process.

    python3 scripts/time_stream_bwd_f32.py DIR [DIR ...]

At (16, 1, 1024, 512) (the perceptual leg's SD-VAE mid-block) and
(16, 1, 1024, 640) (the CNN motion AE's ``MapConv``) it builds every
checkout's ``flash_stream_bwd`` library, runs this checkout's fp32 forward
and delta once, logs each checkout's max|err| against the fp32 plain
backward, then times each checkout's dQ and dK/dV with CUDA events (10
launches back to back after 3 warm-ups, ``chip_smoke._time_ms``) in two
rounds, this checkout first. Another checkout's kernel modules load as
their own package with their custom ops kept out of torch's registry
(``chip_smoke._LocalOp``). Prints the card's name and power limit first.
"""
import importlib
import importlib.util
import os
import sys
import threading
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hivae_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

SHAPES = [(16, 1, 1024, 512), (16, 1, 1024, 640)]


def _load(root, name):
    kdir = os.path.join(os.path.abspath(root), "hivae_tpu_torch", "ops",
                        "kernels")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(kdir, "__init__.py"),
        submodule_search_locations=[kdir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    with mock.patch.object(torch.library, "custom_op",
                           lambda *a, **k: cs._LocalOp):
        return importlib.import_module(name + ".flash_attention")


def main() -> int:
    if not torch.cuda.is_available():
        print("time_stream_bwd_f32: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs._card_line(), flush=True)
    t0 = time.perf_counter()
    mods = [("this", fa)] + [(d, _load(d, f"timed_kernels_{i}"))
                             for i, d in enumerate(sys.argv[1:])]
    errors = []

    def build(m):
        try:
            m._build.build(["flash_stream", "flash_stream_bwd"])
        except Exception as e:   # reported below, with nvcc's output
            errors.append(str(e)[-3000:])
    threads = [threading.Thread(target=build, args=(m,)) for _, m in mods]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    if errors:
        print("\n".join(errors))
        return 1
    for name, m in mods:
        for line in cs._ptxas_summary(
                m._build.BUILD_LOG.get("flash_stream_bwd", "")):
            if "bwd_d" in line and "f32" in line:
                print(name, line, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for shape in SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(4))
        kw = dict(scale=shape[3] ** -0.5, bias=None)
        out, lse = fa.stream_attention(q, k, v, **kw)
        delta = fa.stream_attention_delta(do, out)
        want = fa.stream_attention_bwd_plain(q, k, v, do, out, lse, **kw)
        for name, m in mods:
            got = (m.stream_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
                   *m.stream_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
            torch.cuda.synchronize()
            print(shape, name, "max|err| dq/dk/dv",
                  [f"{cs._abs_err(a, w):.3g}" for a, w in zip(got, want)],
                  flush=True)
        for _ in range(2):
            for name, m in mods:
                dq = cs._time_ms(lambda: m.stream_attention_bwd_dq(
                    q, k, v, do, lse, delta, **kw), 10)
                dkv = cs._time_ms(lambda: m.stream_attention_bwd_dkv(
                    q, k, v, do, lse, delta, **kw), 10)
                print(shape, name, f"dq {dq:.4f} ms dkv {dkv:.4f} ms",
                      flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
