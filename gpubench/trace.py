"""A profiled sub-window and what is read from it.

`capture(fn)` runs fn once under the profiler (the device's activity and
the CUDA runtime's calls), inside a "gpubench.window" range, and keeps in
memory only what the readers need: the device's kernels, copies and sets,
and the host's runtime calls, each as (name, start, end) in nanoseconds.
Nothing is written to disk.
"""

from __future__ import annotations

import functools
import json
import re
from pathlib import Path

import torch

WINDOW = "gpubench.window"
_BUCKETS = json.loads((Path(__file__).parent / "buckets.json").read_text())
_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST = {"host"}


class Trace:
    def __init__(self, window, device, host):
        self.window = window  # (start, end) ns of the window
        self.device = device  # [(name, start, end, kind)] sorted by start
        self.host = host  # [(name, start, end)] on the window's thread, sorted by start

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def kernels(self):
        return [e for e in self.device if e[3] == "kernel"]

    def busy_intervals(self):
        """The union of device activity, clipped to the window."""
        w0, w1 = self.window
        out = []
        for _, s, e, _ in self.device:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def bucket_seconds(self) -> dict:
        """Device seconds by bucket (buckets.json)."""
        out = {b: 0.0 for b in _BUCKETS["order"]}
        for name, s, e, _ in self.device:
            out[bucket(name)] += (e - s) * 1e-9
        return out

    def top_ops(self, n: int = 10):
        """The device operations that took most time: [[name, seconds], ...]."""
        acc = {}
        for name, s, e, _ in self.device:
            key = short(name)
            acc[key] = acc.get(key, 0.0) + (e - s) * 1e-9
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """Device idle time inside the window by what the host was doing:
        each gap named by the innermost host event (on a card, the CUDA
        runtime call; "host (no runtime call)" where the host ran Python or
        the dispatcher between calls) at its middle, summed by name; the n
        largest."""
        w0, w1 = self.window
        busy = self.busy_intervals()
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
        acc, stack, i = {}, [], 0
        host = self.host
        for mid, length in mids:
            while i < len(host) and host[i][1] <= mid:
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            inner = next((h for h in reversed(stack) if h[1] <= mid <= h[2]), None)
            key = inner[0] if inner else "host (no runtime call)"
            acc[key] = acc.get(key, 0.0) + length * 1e-9
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


@functools.lru_cache(maxsize=None)
def bucket(name: str) -> str:
    low = name.lower()
    for b in _BUCKETS["order"]:
        if any(re.search(p, low) for p in _BUCKETS["patterns"][b]):
            return b
    return "other"


@functools.lru_cache(maxsize=None)
def short(name: str, width: int = 120) -> str:
    """A kernel's name without its template arguments and parameters."""
    s = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in s:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or s)[:width]


def _record(fn, cuda: bool):
    """(fn's result, [(name, activity, start, end, thread)]) of fn run under
    the Kineto profiler. On a card only the device's activity and the CUDA
    runtime's calls are recorded: recording every host operator as well
    slows a launch-bound host by half or more, and the sub-window would
    then measure the profiler. The profiler's results are read directly,
    without building torch.profiler's per-event Python objects."""
    from torch.autograd import profiler as ap
    from torch.profiler import ProfilerActivity, record_function

    acts = {ProfilerActivity.CUDA} if cuda else {ProfilerActivity.CPU}
    config = torch._C._profiler.ProfilerConfig(ap.ProfilerState.KINETO, False, False, False, False, False,
                                                torch._C._profiler._ExperimentalConfig())
    ap._prepare_profiler(config, acts)
    ap._enable_profiler(config, acts)
    try:
        with record_function(WINDOW):
            result = fn()
    finally:
        results = ap._disable_profiler()
    return result, [_event(e) for e in results.events()]


def _event(e):
    """(name, kind, start ns, end ns, thread) of a profiler event; kind is
    "kernel", "gpu_memcpy", "gpu_memset" or "host"."""
    name = e.name()
    start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
    dur = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        low = name.lower()
        kind = "gpu_memcpy" if low.startswith("memcpy") else "gpu_memset" if low.startswith("memset") else "kernel"
    else:
        kind = "host"
    return name, kind, start, start + dur, e.start_thread_id()


def capture(fn) -> tuple[object, Trace]:
    """(fn's result, the Trace of its run). fn must end by synchronising;
    the window is the "gpubench.window" range where the profiler keeps it,
    else from the first runtime call to the end of the last (that final
    synchronise)."""
    result, events = _record(fn, torch.cuda.is_available())
    win = [e for e in events if e[0] == WINDOW and e[1] in _HOST]
    host_kinds = [e for e in events if e[1] in _HOST and e[0] != WINDOW]
    if win:
        w0, w1, thread = win[0][2], win[0][3], win[0][4]
    else:
        bounds = host_kinds or [e for e in events if e[1] in _DEVICE]
        w0, w1 = min(e[2] for e in bounds), max(e[3] for e in bounds)
        threads = [e[4] for e in host_kinds]
        thread = max(set(threads), key=threads.count) if threads else None
    # the range itself also shows on the device's timeline: not an operation
    device = sorted(((n, s, e, k) for n, k, s, e, _ in events
                     if k in _DEVICE and n != WINDOW and w0 <= s <= w1), key=lambda d: d[1])
    host = sorted(((n, s, e) for n, k, s, e, t in events if k in _HOST and t == thread and n != WINDOW),
                  key=lambda h: (h[1], -h[2]))
    return result, Trace((w0, w1), device, host)
