"""Profiling hooks (the port's counterparts of ``hivae_tpu/utils/
profiling.py``): a ``torch.profiler`` trace of a region written as a
Chrome trace, named regions on the profiler's timeline, a wall-clock step
timer with an EMA, and the card's memory statistics."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the region (host, and the card where there is one) and
    write ``log_dir/trace.json`` (Chrome trace format)."""
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region on the profiler's timeline."""
    return record_function(name)


class StepTimer:
    """EMA wall-clock step timer with an items-per-second helper."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self._t0: Optional[float] = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else \
            self.ema * self.avg + (1 - self.ema) * dt
        return dt

    def stats(self, items_per_step: float = 1.0) -> Dict[str, float]:
        if self.avg is None:
            return {}
        return {"step_time_s": self.avg,
                "items_per_sec": items_per_step / self.avg}


def device_memory_stats() -> Dict[str, float]:
    """Memory in use and its peak, in GiB, of each visible card (empty
    without one)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"device{i}_bytes_in_use_gib"] = \
            s.get("allocated_bytes.all.current", 0) / 2 ** 30
        out[f"device{i}_peak_gib"] = \
            s.get("allocated_bytes.all.peak", 0) / 2 ** 30
    return out
