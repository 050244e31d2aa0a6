"""The readings a cell's check limits are set from, many seeds in one
process:

    python3 -m gpubench.calibrate --workload <name> --seeds 1,2,3 --modes program,control

Each mode prints, for each seed, one JSON line of the numbers the check
compares. "program" is a run of the cell with the shortest window (one
batch or step); "control" puts the cell's lower-precision control in the
program's place (a swap cell: the program's int8 path; a training cell:
the reference in fp8); a training cell also takes "half" (the fault that
leaves out half of each batch). Limits go into limits/<workload>.json with
the readings they were set from (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from gpubench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--modes", default="program")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpubench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    man = harness.manifest()
    cell = harness.entry(man["workloads"], args.workload)
    cfg = harness.config(man, cell["config"])
    traffic = harness.data("traffic", cell["traffic"])
    drv = harness.driver(traffic)
    limits = harness.data("limits", args.workload)
    modes = args.modes.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        runs = [m for m in modes if m == "program" or (m == "control" and not hasattr(drv, "faults"))]
        for mode in runs:
            t0 = time.perf_counter()
            state = drv.setup(cfg, traffic, seed, "cuda", control=mode == "control")
            drv.window(state, args.seconds)
            failed = drv.outcomes(state)[1]
            out = {name: v for name, v, _ in drv.check(state, limits)}
            out.update(failed=failed, **state.diagnostics)
            del state
            print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed, **out,
                              "seconds": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
        kinds = [m for m in modes if m not in runs]
        if kinds:
            t0 = time.perf_counter()
            for kind, out in drv.faults(cfg, traffic, seed, "cuda", kinds).items():
                print(json.dumps({"workload": args.workload, "mode": kind, "seed": seed, **out,
                                  "seconds": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"limits": limits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
