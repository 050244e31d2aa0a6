"""Tests that need the card, at the cells' own sizes (skipped without one):

    python3 -m pytest gpubench -m card -q

One short run of each cell, as the benchmark's command runs it; each
cell's lower-precision control on three seeds, which the check must refuse
(the swap cell: the program's int8 path; the training cell: the reference
in fp8 put in the program's place); the training cell's half-batch fault,
likewise.
"""

import json
import subprocess
import sys

import pytest

from gpubench import harness

pytestmark = pytest.mark.card
CELLS = ("swap512_b10", "train512_full_b8")
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.parametrize("workload", CELLS)
def test_short_run(card, workload):
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", workload, "--seed",
                          str(2**31 + 7), "--seconds", "5", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result


def _refused(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits if k != "why")


@pytest.mark.parametrize("seed", SEEDS)
def test_swap_control_is_refused(card, seed):
    r = harness.run_cell("swap512_b10", seed, 0.0, False, card, control=True)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("kind", ("control", "half"))
@pytest.mark.parametrize("seed", SEEDS)
def test_train_control_and_fault_are_refused(card, seed, kind):
    man = harness.manifest()
    cfg = harness.config(man, "reface_sd14_512_train")
    traffic = harness.data("traffic", "train_full_b8")
    from gpubench.drivers import train

    numbers = train.faults(cfg, traffic, seed, card, [kind])[kind]
    assert _refused(numbers, harness.data("limits", "train512_full_b8")), numbers
