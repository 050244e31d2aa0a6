"""Tracing and profiling utilities (port of reface_tpu/core/profiling.py).

Reference equivalent: CUDACallback (main.py:423-443), per-epoch wall clock
and peak memory. Here: per-step timing that synchronises the card at its
sample points, a torch.profiler trace written under a directory, and the
card's memory counters under the JAX package's three keys.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["StepTimer", "trace", "device_memory_stats"]


def _sync(device=None) -> None:
    if torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)


class StepTimer:
    """Rolling per-step timing, synchronising the card at its sample points."""

    def __init__(self, sync_every: int = 50, device=None):
        self.sync_every = sync_every
        self.device = device
        self.t0: Optional[float] = None
        self.steps = 0
        self.history: list[float] = []

    def start(self):
        _sync(self.device)
        self.t0 = time.perf_counter()
        self.steps = 0

    def step(self, result=None) -> Optional[float]:
        """Call once per train step; returns steps/s at the sample points.
        `result` is accepted for the JAX signature: the synchronisation
        waits for all of the card's work."""
        self.steps += 1
        if self.steps % self.sync_every:
            return None
        _sync(self.device)
        now = time.perf_counter()
        sps = self.sync_every / (now - self.t0) if self.t0 else 0.0
        self.t0 = now
        self.history.append(sps)
        return sps


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the CPU and (when present) the card; writes a
    Chrome trace, trace.json, under logdir (chrome://tracing, Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats(device=None) -> dict:
    """bytes_in_use, peak_bytes_in_use (the caching allocator's allocated
    bytes, current and peak) and bytes_limit (the card's total memory);
    empty without a card or for a device that is not one."""
    if not torch.cuda.is_available() or (device is not None
                                         and torch.device(device).type != "cuda"):
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.mem_get_info(device)[1],
    }
