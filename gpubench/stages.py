"""The profiled sub-window's device idle put down to the program's stages.

The program records its stage spans (reface_tpu_torch/core/profiling.py:
`swap.*`, `train.*`) while a profiler runs, stamped in Unix-epoch ns like
the profiler's events, and counts its hand-written kernels' launches in
the innermost open span. `idle_in(ctx, names)` is the share of the
sub-window in which the device is idle while the host is inside one of the
named spans. A program without spans gives None.
"""

from __future__ import annotations


def recorded() -> list:
    """The program's span records, or [] where it keeps none."""
    try:
        from reface_tpu_torch.core.profiling import spans
    except ImportError:
        return []
    return spans()


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_intervals(tr):
    """The window minus the device's busy intervals."""
    w0, w1 = tr.window
    edges = [w0] + [x for iv in tr.busy_intervals() for x in iv] + [w1]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def _overlap_ns(a, b) -> int:
    """The total length of the intersection of two sorted lists of
    disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _inside(tr, records, names):
    """The union of the named spans' intervals, clipped to the window."""
    w0, w1 = tr.window
    return _union((max(r[3], w0), min(r[4], w1)) for r in records
                  if r[2] in names and min(r[4], w1) > max(r[3], w0))


def idle_in(ctx, names, records=None):
    """The share of the profiled sub-window, in %, in which the device is
    idle and the host is inside a span named in `names`; None without a
    sub-window or where no such span was recorded in it. `records`
    defaults to the program's."""
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0.0:
        return None
    inside = _inside(tr, recorded() if records is None else records, set(names))
    if not inside:
        return None
    return 100.0 * _overlap_ns(idle_intervals(tr), inside) * 1e-9 / tr.window_s

