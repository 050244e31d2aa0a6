"""The port's stage spans and launch counters (reface_tpu_torch/core/
profiling.py, ops/kernels.py::count_launch) on the CPU: nothing recorded
without a profiler; ids and parents of nested spans; a launch counted from
another thread in the span open on the first; the spans on the clock of
the profiler's events; the span trees of a tiny swap and of a tiny
full-loss training step; the spans in trace()'s trace.json.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_port_helpers import one_torch_thread

from reface_tpu_torch.core import profiling
from reface_tpu_torch.ops import kernels
from reface_tpu_torch.pipelines import train as PT
from reface_tpu_torch.pipelines.swap import FaceSwapper, tiny_swap_config

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _last_id() -> int:
    return max((r.id for r in profiling.spans()), default=0)


def _new(before: int):
    """The spans recorded since the newest id was `before`."""
    return [r for r in profiling.spans() if r.id > before]


def _tree(records):
    """{name: sorted names of its children} of the records."""
    by_id = {r.id: r for r in records}
    out = {}
    for r in records:
        out.setdefault(r.name, set())
        if r.parent in by_id:
            out.setdefault(by_id[r.parent].name, set()).add(r.name)
    return {k: sorted(v) for k, v in out.items()}


def _wrapper():
    def fake_kernel():
        pass

    fake_kernel.launches, fake_kernel.shapes = 0, None
    return fake_kernel


def test_off_records_nothing():
    before = _last_id()
    k = _wrapper()
    a, b = profiling.span("x"), profiling.span("y")
    assert a is b  # one shared null context
    with a:
        kernels.count_launch(k, (1,))
    assert _last_id() == before and k.launches == 1


def test_nested_ids_and_parents():
    before = _last_id()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer") as outer:
            with profiling.span("inner.a"):
                pass
            with profiling.span("inner.b"):
                with profiling.span("leaf"):
                    pass
    got = {r.name: r for r in _new(before)}
    assert [r.name for r in _new(before)] == ["inner.a", "leaf", "inner.b", "outer"]
    assert got["outer"].id == outer.id
    assert got["inner.a"].parent == got["inner.b"].parent == outer.id
    assert got["leaf"].parent == got["inner.b"].id and got["outer"].parent is None
    assert len({r.id for r in got.values()}) == 4
    for r in got.values():
        assert r.start_ns <= r.end_ns
    assert got["outer"].start_ns <= got["inner.a"].start_ns <= got["inner.b"].end_ns \
        <= got["outer"].end_ns


def test_launch_from_other_threads_counts_in_the_open_span():
    """The backward's kernels are launched from autograd's own thread, on
    which no profiler is enabled: they count in the span open on the first,
    and no count is lost when threads launch at once."""
    before = _last_id()
    k = _wrapper()
    n_threads, each = 8, 5000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("train.backward"):
                kernels.count_launch(k, (2, 3))
                threads = [threading.Thread(target=lambda: [kernels.count_launch(k, (2, 3))
                                                            for _ in range(each)])
                           for _ in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    (rec,) = _new(before)
    assert rec.counts == {"fake_kernel": 1 + n_threads * each}


def test_spans_share_the_profilers_clock():
    """A torch op profiled inside a span lies within the span's
    [start, end], within 0.5 ms."""
    before = _last_id()
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm"):
            torch.mm(x, x)
    (rec,) = _new(before)
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert ops
    for e in ops:
        start = e.start_ns()
        end = start + e.duration_ns()
        assert start >= rec.start_ns - 500_000 and end <= rec.end_ns + 500_000


def _swap_inputs(b, size, seed=0):
    rng = np.random.default_rng(seed)
    target = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    mask = (rng.uniform(size=(b, size, size, 1)) > 0.5).astype(np.float32)
    return dict(target_image=target, inpaint_image=target * mask, inpaint_mask=mask,
                ref_clip224=rng.normal(size=(b, 224, 224, 3)).astype(np.float32),
                landmarks=rng.uniform(0, size, (b, 136)).astype(np.float32))


def test_swap_span_tree_and_trace_json(tmp_path):
    swapper = FaceSwapper(tiny_swap_config(image_size=64, ddim_steps=2), device="cpu")
    before = _last_id()
    with profiling.trace(str(tmp_path)):
        out = swapper.swap(**_swap_inputs(1, 64))
    assert out.shape == (1, 64, 64, 3)
    recs = _new(before)
    assert _tree(recs) == {"swap": ["swap.condition", "swap.decode", "swap.encode", "swap.sample"],
                           "swap.condition": [], "swap.encode": [], "swap.sample": [],
                           "swap.decode": []}
    order = sorted((r for r in recs if r.name != "swap"), key=lambda r: r.start_ns)
    assert [r.name for r in order] == ["swap.condition", "swap.encode", "swap.sample", "swap.decode"]
    doc = json.loads((tmp_path / "trace.json").read_text())
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    assert sorted(e["name"] for e in spans) == sorted(r.name for r in recs)
    # on the ops' clock: each stage holds ops, and an op that starts inside
    # a span ends inside it, within 0.5 ms
    ops = [e for e in doc["traceEvents"]
           if e.get("cat") == "cpu_op" and e["tid"] == threading.get_native_id()]
    assert ops
    for s in spans:
        inside = [e for e in ops if s["ts"] <= e["ts"] <= s["ts"] + s["dur"]]
        assert inside, s["name"]
        for e in inside:
            assert e["ts"] + e["dur"] <= s["ts"] + s["dur"] + 500.0, (s["name"], e["name"])
    (root,) = [s for s in spans if s["name"] == "swap"]
    for e in ops:
        assert root["ts"] - 500.0 <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 500.0


def test_full_loss_step_span_tree():
    step, _, init_state = PT.make_train_step(tiny_swap_config(64), PT.TrainConfig(warmup_steps=1),
                                             recon=PT.ReconLossConfig(), device="cpu")
    state = init_state(seed=3)
    batch = _swap_inputs(2, 64, seed=1)
    draws = PT.make_draws(2, 8, PT.TrainConfig(), "cpu", torch.Generator().manual_seed(0))
    before = _last_id()
    with profile(activities=[ProfilerActivity.CPU]):
        _, metrics = step(state, batch, draws)
    assert torch.isfinite(metrics["loss"])
    assert _tree(_new(before)) == {
        "train.step": ["train.backward", "train.forward", "train.update"],
        "train.forward": ["train.eps", "train.prep", "train.recon", "train.towers"],
        "train.prep": [], "train.eps": [], "train.recon": [], "train.towers": [],
        "train.backward": [], "train.update": []}
