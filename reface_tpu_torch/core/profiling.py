"""Tracing and profiling utilities (port of reface_tpu/core/profiling.py).

Reference equivalent: CUDACallback (main.py:423-443), per-epoch wall clock
and peak memory. Here: stage spans and kernel-launch counters recorded
while a profiler runs, a torch.profiler trace written under a directory
with the spans on a track of their own, and the card's memory counters
under the JAX package's three keys.

Spans. `span(name)` marks a stage of the swap or the training step
(`swap`, `swap.condition`, `swap.encode`, `swap.sample`, `swap.decode`;
`train.step`, `train.forward` with `train.prep`, `train.eps`, `train.recon`
and `train.towers` inside it, `train.backward`, `train.update`). It records
only while a profiler runs on the calling thread (torch.profiler, or the
Kineto profiler enabled directly); otherwise it is one shared null context. A record is
(id, parent id, name, start_ns, end_ns, counts): the parent is the
innermost span open in the process, the stamps are Unix-epoch ns (the
clock of the profiler's events, so a span lines up with the device's
trace), and `counts` holds the hand-written kernels' launches by wrapper
name (`ops/kernels.py::count_launch`) made while it was the innermost open
span, from any thread: the backward's launches come from autograd's own
thread. A span is not a `record_function` range, so it never shows on the
device's timeline. `spans()` returns the records, the newest MAX_SPANS.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple, Optional

import torch

__all__ = ["span", "spans", "SpanRecord", "MAX_SPANS", "count_kernel", "trace",
           "device_memory_stats"]

MAX_SPANS = 65536
# whether a profiler runs on the calling thread
_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_OPEN: list = []  # the open spans of the process, innermost last
_RECORDS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_COUNT_LOCK = threading.Lock()  # launches are counted from autograd's threads too
_SPAN_TID = 1 << 22  # above Linux's largest thread id: trace()'s track of its own


class SpanRecord(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    counts: dict


class _Span:
    __slots__ = ("name", "id", "parent", "start_ns", "counts")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.id = next(_IDS)
        self.parent = _OPEN[-1].id if _OPEN else None
        self.counts = {}
        _OPEN.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _OPEN.remove(self)
        _RECORDS.append(SpanRecord(self.id, self.parent, self.name, self.start_ns, end,
                                   self.counts))
        return False


def span(name: str):
    """A context manager that records the stage `name` while a profiler
    runs on this thread, and does nothing otherwise."""
    return _Span(name) if _enabled() else _NULL


def spans() -> list[SpanRecord]:
    """The closed spans recorded so far, oldest first."""
    return list(_RECORDS)


def count_kernel(name: str) -> None:
    """Add one to counts[name] of the innermost open span, if any."""
    for top in _OPEN[-1:]:
        with _COUNT_LOCK:
            top.counts[name] = top.counts.get(name, 0) + 1


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the CPU and (when present) the card; writes a
    Chrome trace, trace.json, under logdir (chrome://tracing, Perfetto),
    with the spans recorded inside it as complete events on a track of
    their own ("program spans"). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    t0 = time.time_ns()
    with profile(activities=acts) as prof:
        yield prof
    t1 = time.time_ns()
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)  # the events' "ts" is in us from it
    pid, tid = os.getpid(), _SPAN_TID
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": "program spans"}}]
    for r in spans():
        if r.start_ns >= t0 and r.end_ns <= t1:
            events.append({"ph": "X", "cat": "span", "name": r.name, "pid": pid, "tid": tid,
                           "ts": (r.start_ns - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
                           "args": {"id": r.id, "parent": r.parent, **r.counts}})
    doc["traceEvents"] = doc.get("traceEvents", []) + events
    with open(path, "w") as f:
        json.dump(doc, f)


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
