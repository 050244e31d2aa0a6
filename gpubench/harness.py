"""One run of one cell: set-up, the measured window, the profiled
sub-window, the check against the reference, and the result.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name BENCHMARK.json gives it:
configs/<config>.json, traffic/<traffic>.json (which names its driver,
drivers/<driver>.py), limits/<workload>.json (the check's limits) and
metrics/<metric>.py (a `read(ctx)` that returns the metric's value, or None
where it finds nothing to read).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that must not be loaded by a run (compared whole:
# the measured package's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "reface_tpu")
GIB = 2.0**30


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def entry(items: list, name: str) -> dict:
    found = [x for x in items if x["name"] == name]
    if not found:
        raise KeyError(f"no entry named {name!r}")
    return found[0]


def data(kind: str, name: str) -> dict:
    """gpubench/<kind>/<name>.json."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def config(man: dict, name: str) -> dict:
    return json.loads((ROOT / entry(man["configs"], name)["file"]).read_text())


def driver(traffic: dict):
    return importlib.import_module(f"gpubench.drivers.{traffic['driver']}")


def reader(metric: str):
    """The `read` function of gpubench/metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def sub_seed(seed: int, tag: int) -> int:
    """A generator seed derived from the run's seed and a tag."""
    return (int(seed) * 1_000_003 + tag) % (2**63 - 1)


def device_info(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def _log(msg: str) -> None:
    print(f"gpubench: {msg}", file=sys.stderr, flush=True)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             man: dict | None = None, cfg: dict | None = None, control: bool = False) -> dict:
    """The result of one run (the dict the result line prints). cfg
    defaults to the cell's configuration file; `control` runs the cell's
    lower-precision control in the program's place."""
    t0 = time.perf_counter()
    man = man or manifest()
    cell = entry(man["workloads"], workload)
    cfg = cfg or config(man, cell["config"])
    traffic = data("traffic", cell["traffic"])
    limits = data("limits", workload)
    drv = driver(traffic)
    state = drv.setup(cfg, traffic, seed, device, control=control)
    _sync(device)
    setup_s = time.perf_counter() - t0
    _log(f"set-up {setup_s:.3f} s")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    win = drv.window(state, seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    _log(f"window {win['seconds']:.3f} s, {win['units']} units")
    leaked = forbidden_modules()
    if leaked:
        raise RuntimeError(f"the run loaded {', '.join(leaked)}")
    tr = None
    if trace:
        from gpubench.trace import capture

        t1 = time.perf_counter()
        trace_units, tr = capture(lambda: drv.profile(state))
        _log(f"profiled sub-window {tr.window_s:.3f} s, captured and reduced in {time.perf_counter() - t1:.3f} s")
    attempted, failed = drv.outcomes(state)
    e2e = {traffic["rate_metric"]: win["units"] / win["seconds"], "peak_mem_gib": peak / GIB,
           "setup_s": setup_s}
    ctx = {"cfg": cfg, "traffic": traffic, "driver": drv, "state": state, "window": win,
           "trace": tr, "trace_units": trace_units if trace else None}
    metrics = {}
    t1 = time.perf_counter()
    if trace:
        for m in man["per_layer"]:
            if applies(m, workload):
                v = reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in man["end_to_end"]:
            if applies(m, workload) and m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    _log(f"metrics read in {time.perf_counter() - t1:.3f} s")
    t1 = time.perf_counter()
    numbers = drv.check(state, limits)
    _log(f"check {time.perf_counter() - t1:.3f} s")
    correct = failed == 0 and all(v <= lim for _, v, lim in numbers)
    dev = device_info(device, cell["chips"])
    dev["memory_peak_bytes"] = int(peak)
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        result["device_buckets"] = [[k, v] for k, v in tr.bucket_seconds().items() if v]
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in numbers}
    return result
