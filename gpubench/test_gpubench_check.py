"""The check that decides `correct`, on the CPU at the tiny widths: the
reference agrees with the program where both compute in fp32, and a run
whose timed path is broken underneath comes out not correct, once for each
fault the cells can have. Cell-size runs are in test_gpubench_card.py."""

import ast

import pytest
import torch

from gpubench import harness, tiny

SWAP, TRAIN = "swap512_b10", "train512_full_b8"


@pytest.fixture(autouse=True)
def small(monkeypatch):
    tiny.tiny_traffic(monkeypatch)
    torch.set_num_threads(4)


def run(workload, seed=2**31 + 11, **kw):
    return harness.run_cell(workload, seed, 0.0, False, "cpu", cfg=tiny.tiny_config(workload), **kw)


def test_swap_reference_is_the_program_in_fp32():
    """Both sides fp32: only the order of sums differs (2e-6 of the image's
    norm seen), far under one 8-bit level."""
    r = run(SWAP)
    assert r["correct"] and r["failed"] == 0
    assert r["check"]["share_off_3_levels"]["value"] == 0.0


def test_train_reference_is_the_program_in_fp32():
    """Both sides fp32 over three steps: loss 1e-7, gradient 2e-5 and change
    7e-5 of the median leaf seen; the margins are for other BLAS builds."""
    r = run(TRAIN)
    assert r["correct"] and r["failed"] == 0
    got = {k: v["value"] for k, v in r["check"].items()}
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-3 and got["change_gap"] < 1e-3, got


def test_swap_control_reads_far_above_the_program():
    """The int8 control, tiny and fp32 otherwise, moves values by whole
    levels where the fp32 program moves none."""
    assert run(SWAP)["check"]["share_off_3_levels"]["value"] == 0.0
    control = run(SWAP, control=True)["check"]["share_off_3_levels"]["value"]
    assert control > 0.05, control


def test_answer_altered_where_produced(monkeypatch):
    from reface_tpu_torch.pipelines.swap import FaceSwapper

    swap = FaceSwapper.swap

    def altered(self, *a, **kw):
        """Every image's top-left quarter mirrored in value."""
        out = swap(self, *a, **kw).clone()
        h = out.shape[1] // 2
        out[:, :h, :h] = -out[:, :h, :h]
        return out

    monkeypatch.setattr(FaceSwapper, "swap", altered)
    assert not run(SWAP, seed=3)["correct"]


def test_half_the_batch_left_out_swap(monkeypatch):
    from reface_tpu_torch.pipelines.swap import FaceSwapper

    swap = FaceSwapper.swap

    def half(self, **kw):
        """The first half of the pairs swapped, the rest never answered."""
        n = kw["target_image"].shape[0] // 2
        return swap(self, **{k: v[:n] if torch.is_tensor(v) else v for k, v in kw.items()})

    monkeypatch.setattr(FaceSwapper, "swap", half)
    assert not run(SWAP, seed=4)["correct"]


def test_state_returned_unchanged(monkeypatch):
    from reface_tpu_torch.pipelines import train

    monkeypatch.setattr(train.AdamW, "step", lambda self, grads: True)
    r = run(TRAIN, seed=5)
    assert not r["correct"] and r["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_train(monkeypatch):
    """The step's loss and gradients from the first half of its rows (the
    mean taken over them), its draws cut to match."""
    from reface_tpu_torch.pipelines import train

    make = train.make_train_step

    def halved(*a, **kw):
        step, loss_fn, init = make(*a, **kw)

        def half_step(state, batch, draws=None, generator=None):
            n = batch["target_image"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()},
                        {k: v[:n] for k, v in draws.items()}, generator)

        return half_step, loss_fn, init

    monkeypatch.setattr(train, "make_train_step", halved)
    assert not run(TRAIN, seed=6)["correct"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_a_reference_of_its_own():
    """No module of the benchmark imports JAX or the JAX package (top-level
    names compared whole); the reference imports nothing of the program."""
    for path in harness.HERE.rglob("*.py"):
        names = set(_imports(path))
        assert not names & set(harness.FORBIDDEN), path
        if path.parent.name == "reference":
            assert "reface_tpu_torch" not in names, path
    assert harness.forbidden_modules() == []
