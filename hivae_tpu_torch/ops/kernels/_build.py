"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface and loaded with
``ctypes``; each attention source is compiled twice, into ``<name>`` (its
16-bit kernels in bf16, and its fp32 ones) and ``<name>_f16`` (with
``-DHV_F16``: the 16-bit kernels in fp16 only). Libraries are built on first
use into ``hivae_tpu_torch/build/`` (git-ignored), named by a hash of their
sources and flags so an edited kernel is rebuilt, and all requested
libraries compile concurrently (one ``nvcc`` each).
Nothing here runs at import time: this module imports on machines without
a GPU or a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
ATTENTION_SOURCES = ("flash_full_block", "flash_full_block_bwd",
                     "flash_stream", "flash_stream_bwd")
# every library by name: (its source under csrc/, its extra nvcc flags)
LIBRARIES = dict(
    {n: (n, ()) for n in ATTENTION_SOURCES + ("quant_ffn",)},
    **{f"{n}_f16": (n, ("-DHV_F16",)) for n in ATTENTION_SOURCES})
KERNEL_SOURCES = tuple(LIBRARIES)

# nvcc's stderr per source from this process's builds (ptxas register and
# shared-memory report); empty for a library found already built
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str):
    return [*NVCC_FLAGS, *LIBRARIES[name][1]]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{LIBRARIES[name][0]}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES,
          timeout: float = 900.0) -> Dict[str, Path]:
    """Compile every named library (``LIBRARIES``) that has no current
    build, all at once; returns {name: library path}. Raises with nvcc's
    output on failure."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n in names:
        if paths[n].exists():
            continue
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(n), "-o", str(tmp),
               str(CSRC / f"{LIBRARIES[n][0]}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            failed.append(f"{n}: nvcc timed out after {timeout} s")
            continue
        BUILD_LOG[n] = out + err
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{out}{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``LIBRARIES``), building it if
    needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib
