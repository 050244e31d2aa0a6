"""The arithmetic of the per-layer metrics; each file under metrics/ binds
one of these to a metric's name. A reader returns None where its run has
nothing to read (no profiled sub-window, no kernel of its bucket)."""

from __future__ import annotations

from gpubench import flops


def mfu(ctx):
    """Model FLOPs of the window's completed units over the window's
    seconds times the bf16 peak, in %."""
    win = ctx["window"]
    per_unit = ctx["driver"].flops_per_unit(ctx["cfg"], ctx["traffic"])
    return 100.0 * win["units"] * per_unit / (win["seconds"] * flops.PEAKS["bf16_flops_per_s"])


def launches(ctx):
    """Device kernels of the profiled sub-window per unit of work."""
    tr = ctx["trace"]
    if tr is None or not ctx["trace_units"]:
        return None
    return len(tr.kernels()) / ctx["trace_units"]


def roofline_attention(ctx):
    """The least time of the sub-window's attention calls (flops.py) over
    the device time of the kernels buckets.json classes as attention, in %."""
    tr = ctx["trace"]
    if tr is None:
        return None
    spent = tr.bucket_seconds()["attention"]
    if spent <= 0.0:
        return None
    calls = ctx["driver"].profiled_attention_calls(ctx["state"])
    return 100.0 * sum(flops.least_seconds(f, b) for f, b in calls) / spent


def device_idle(ctx):
    """The share of the sub-window's wall time in which no kernel, copy or
    set ran on the device, in %."""
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
