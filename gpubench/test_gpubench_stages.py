"""stages.idle_in on a synthetic Trace and span list: a
gap split across two spans, a span outside the window ignored, None where
nothing was recorded, and the program's spans read where none are given."""

import pytest

from gpubench import stages
from gpubench.trace import Trace

MS = 1_000_000


def _trace():
    """A 100 ms window; the device busy over [10, 40] and [60, 90] ms: idle
    [0, 10], [40, 60] and [90, 100] ms, 40 ms in all."""
    device = [("k1", 10 * MS, 40 * MS, "kernel"), ("k2", 60 * MS, 90 * MS, "kernel")]
    return Trace((0, 100 * MS), device, [])


def _rec(i, name, start_ms, end_ms, parent=None, counts=None):
    return (i, parent, name, int(start_ms * MS), int(end_ms * MS), counts or {})


RECORDS = [
    _rec(1, "train.forward", 5, 50),  # idle inside: [5, 10] and [40, 50] = 15 ms
    _rec(2, "train.backward", 50, 95, counts={"flash_bwd_dq": 2}),  # [50, 60] and [90, 95] = 15 ms
    _rec(3, "train.step", 2, 98),
    _rec(4, "train.forward", 200, 300),  # outside the window
]


def test_a_gap_split_across_two_spans():
    ctx = {"trace": _trace()}
    fwd = stages.idle_in(ctx, ("train.forward",), RECORDS)
    bwd = stages.idle_in(ctx, ("train.backward",), RECORDS)
    assert fwd == pytest.approx(15.0) and bwd == pytest.approx(15.0)
    # a union, not a sum: the step holds both
    assert stages.idle_in(ctx, ("train.forward", "train.backward", "train.step"),
                          RECORDS) == pytest.approx(100.0 * (40 - 2 - 2) / 100)


def test_a_span_outside_the_window_is_ignored():
    ctx = {"trace": _trace()}
    assert stages.idle_in(ctx, ("train.forward",), RECORDS[3:]) is None
    assert stages.idle_in(ctx, ("train.forward",), [RECORDS[0], RECORDS[3]]) == pytest.approx(15.0)


def test_none_when_nothing_was_recorded(monkeypatch):
    ctx = {"trace": _trace()}
    assert stages.idle_in(ctx, ("swap.sample",), []) is None
    assert stages.idle_in({"trace": None}, ("swap.sample",), RECORDS) is None
    monkeypatch.setattr(stages, "recorded", lambda: RECORDS)
    assert stages.idle_in(ctx, ("train.backward",)) == pytest.approx(15.0)
