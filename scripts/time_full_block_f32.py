"""Time the fp32 full-block forward, qk-norm forward and backward of this
checkout and of other checkouts (the parent commit unpacked with ``git
archive``, or a copy of this tree with one edit, such as a part of a
kernel compiled out) in turns, on one card, in one process.

    python3 scripts/time_full_block_f32.py DIR [DIR ...]

At the `--mp no` flagship step's camera joint block (32, 16, 512, 64), its
object joint block (32, 16, 266, 64), MAE_L's encoder at mask 0 (4, 16,
257, 64), Sq 300 against Sk 700 on 8 heads, the T2M joint block (16, 16,
269, 128) and AMD_L's DiT joint block (4, 16, 282, 96) it builds every
checkout's ``flash_full_block`` and ``flash_full_block_bwd`` libraries,
logs each checkout's max|err| against the fp32 plain versions, then times
each checkout's forward, qk-norm forward and backward (the delta pre-pass
and the dQ and dK/dV launch) with CUDA events (20 launches back to back
after 3 warm-ups, ``chip_smoke._time_ms``) in two rounds, this checkout
first, and the device time of their kernels alone
(``chip_smoke._device_ms``: a call that takes less device time than the
host takes to launch it times the host under CUDA events); another checkout whose
kernels do not build is reported and left out. Another checkout's
kernel modules load as their own package with
their custom ops kept out of torch's registry (``chip_smoke._LocalOp``).
Prints the card's name and power limit first.
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

# (q shape, Sk)
SHAPES = [((32, 16, 512, 64), 512), ((32, 16, 266, 64), 266),
          ((4, 16, 257, 64), 257), ((2, 4, 300, 64), 700),
          ((16, 16, 269, 128), 269), ((4, 16, 282, 96), 282)]
LIBS = ["flash_full_block", "flash_full_block_bwd"]


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
        print("time_full_block_f32: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs._card_line(), flush=True)
    t0 = time.perf_counter()
    mods = [("this", fa)] + [(d, _load(d, f"timed_kernels_{i}"))
                             for i, d in enumerate(sys.argv[1:])]
    errors = {}

    def build(name, m):
        try:
            m._build.build(LIBS)
        except Exception as e:   # reported below, with nvcc's output
            errors[name] = str(e)[-3000:]
    threads = [threading.Thread(target=build, args=nm) for nm in mods]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, err in errors.items():
        print(f"{name}: left out, its kernels did not build:\n{err}")
    if "this" in errors:
        return 1
    mods = [(name, m) for name, m in mods if name not in errors]
    for name, m in mods:
        for lib in LIBS:
            for line in cs._ptxas_summary(m._build.BUILD_LOG.get(lib, "")):
                if "f32" in line and "delta" not in line:
                    print(name, line, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for shape, sk in SHAPES:
        kv = shape[:2] + (sk, shape[3])
        q, do = (torch.randn(shape, generator=gen, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn(kv, generator=gen, device="cuda")
                for _ in range(2))
        norms = cs._norm_params(gen, shape[3])
        kw = dict(scale=shape[3] ** -0.5, bias=None)
        out, m, l = fa._full_block_fwd(q, k, v, None, kw["scale"], stats=True)
        want = (fa.full_block_attention_plain(q, k, v, **kw),
                fa.full_block_attention_qknorm_plain(q, k, v, *norms, **kw),
                *fa.full_block_attention_bwd_plain(q, k, v, do, **kw))
        for name, mod in mods:
            got = (mod.full_block_attention(q, k, v, **kw),
                   mod.full_block_attention_qknorm(q, k, v, *norms, **kw),
                   *mod.full_block_attention_bwd(q, k, v, do, out, m, l,
                                                 **kw))
            torch.cuda.synchronize()
            print(shape, sk, name, "max|err| o/qknorm/dq/dk/dv",
                  [f"{cs._abs_err(a, w):.3g}" for a, w in zip(got, want)],
                  flush=True)
        for _ in range(2):
            for name, mod in mods:
                f = cs._time_ms(lambda: mod.full_block_attention(q, k, v,
                                                                 **kw), 20)
                fq = cs._time_ms(lambda: mod.full_block_attention_qknorm(
                    q, k, v, *norms, **kw), 20)
                b = cs._time_ms(lambda: mod.full_block_attention_bwd(
                    q, k, v, do, out, m, l, **kw), 20)
                print(shape, sk, name, f"fwd {f:.4f} ms qknorm {fq:.4f} ms "
                      f"bwd {b:.4f} ms", flush=True)
        for name, mod in mods:
            dev = [cs._device_ms(fn, "full_block") for fn in (
                lambda: mod.full_block_attention(q, k, v, **kw),
                lambda: mod.full_block_attention_qknorm(q, k, v, *norms,
                                                        **kw),
                lambda: mod.full_block_attention_bwd(q, k, v, do, out, m, l,
                                                     **kw))]
            print(shape, sk, name, "device time: fwd {} ms qknorm {} ms "
                  "bwd (with delta) {} ms".format(
                      *(cs._ms_or_none(x) for x in dev)), flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
