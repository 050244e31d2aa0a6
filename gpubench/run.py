"""Run one cell of the benchmark once and print its result line.

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The run needs an
NVIDIA card (as many as the cell asks for) and never falls back to the CPU.
Its last line on standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, then check); the last
lines on standard error give each number the check compared beside its
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gpubench.harness import ROOT

# every cache the program or its libraries keep lives at a fixed path inside
# the checkout, so that only a checkout's first run builds
_CACHE = ROOT / "build" / "gpubench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "cuda_cache")
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "4")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from gpubench import harness

    man = harness.manifest()
    cell = harness.entry(man["workloads"], args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"gpubench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", man=man)
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"gpubench: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
