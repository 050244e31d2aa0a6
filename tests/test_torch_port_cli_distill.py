"""The port's distillation driver (reface_tpu_torch/cli/distill.py) on the CPU
at the tiny config: its files and report lines, the manifest the JAX driver
writes for the same flags, the rounds of the plan, the frozen towers, the
teacher checkpoint, the dataset and synthetic batches, and the student served
through cli.swap --ckpt <out>/params.pt --ddim-steps K --scale 1.0.

The JAX driver is not run (its jitted step compiles for minutes here): its
manifest and its synthetic batch stream are the formulas of
reface_tpu/cli/distill.py, with its schedule plan taken from
reface_tpu.diffusion.distill.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from test_torch_port_helpers import one_torch_thread

from reface_tpu.diffusion.distill import distill_schedule_plan as j_plan
from reface_tpu_torch.ckpt import io as ckpt_io
from reface_tpu_torch.ckpt.from_torch import is_swap_params, save_swap_params
from reface_tpu_torch.cli import common as cli_common
from reface_tpu_torch.cli import distill as cli_distill
from reface_tpu_torch.cli import swap as cli_swap
from reface_tpu_torch.data import make_synthetic_celeba
from reface_tpu_torch.io.images import imwrite
from reface_tpu_torch.pipelines.swap import SwapModules, init_params, tiny_swap_config

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TINY = ["--tiny", "--device", "cpu", "--image-size", "64", "--batch-size", "2",
        "--teacher-steps", "4", "--log-every", "1"]


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli_distill.main(argv)
    return out, buf.getvalue()


def _manifest_jax(teacher_steps, target, cfg_scale=3.0, fold=True, max_rounds=0):
    """The manifest reface_tpu/cli/distill.py writes for these flags."""
    plan = j_plan(teacher_steps, target)
    if max_rounds:
        plan = plan[:max_rounds]
    return {"ddim_steps": plan[-1], "cfg_scale": 1.0 if fold else cfg_scale,
            "teacher_steps": teacher_steps, "teacher_cfg_scale": cfg_scale,
            "rounds": plan, "mode": "distilled"}


@pytest.fixture(scope="module")
def one_round(tmp_path_factory):
    out = tmp_path_factory.mktemp("distill") / "run"
    result, text = _run(["--out", str(out), "--target-steps", "2", "--steps-per-round", "2",
                         *TINY])
    return out, result, text


def test_files_manifest_and_report(one_round):
    """params.pt in ckpt/io.py's layout (the student UNet with the shared
    towers), manifest.json equal to the JAX driver's for the same flags,
    timing.jsonl a line a step, and the report lines: the plan, the round,
    each step's loss, the serving flags of cli.swap."""
    out, result, text = one_round
    assert json.loads((out / "manifest.json").read_text()) == _manifest_jax(4, 2)
    params = ckpt_io.load_params(str(out))
    assert is_swap_params(params) and set(params) == {"unet", "vae", "conditioner"}
    student = result["modules"].unet.state_dict()
    assert all(torch.equal(params["unet"][k], v) for k, v in student.items())
    assert "[distill] round plan: 4 -> [2]" in text
    assert "[distill] round 0: 4 -> 2 steps, cfg=3.0, fold=True" in text
    assert text.count("[distill] r0 it") == 2
    assert text.rstrip().splitlines()[-1] == (
        f"[distill] saved student -> {out} (serve: --ckpt {out / 'params.pt'} "
        "--ddim-steps 2 --scale 1.0)")
    timing = [json.loads(line) for line in (out / "timing.jsonl").read_text().splitlines()]
    assert [t["step"] for t in timing] == [1, 2] and all(t["step_s"] > 0 for t in timing)
    assert all(np.isfinite(h["loss"]) for h in result["history"])


def test_student_moves_and_the_rest_is_frozen(one_round):
    """The student moved (with the reference's zero-initialised layers, the
    output conv and the layers ahead of a zero one first); the VAE and the
    conditioner are the seeded random
    init (seed + tower index), bit for bit; the last teacher is a separate
    frozen copy of the student (its weights equal, its tensors not shared)."""
    _, result, _ = one_round
    modules = result["modules"]
    fresh = SwapModules(modules.config, "cpu", param_dtype=torch.float32)
    for i, m in enumerate(fresh.towers().values()):
        init_params(m, seed=i)
    for name in ("vae", "conditioner"):
        ref = fresh.towers()[name].state_dict()
        assert all(torch.equal(v, ref[k]) for k, v in modules.towers()[name].state_dict().items())
    ref = fresh.unet.state_dict()
    moved = [k for k, v in modules.unet.state_dict().items() if not torch.equal(v, ref[k])]
    assert "out.2.weight" in moved and "input_blocks.0.0.weight" in moved
    teacher = result["teacher"]
    assert not any(p.requires_grad for p in teacher.parameters())
    for (k, a), b in zip(teacher.state_dict().items(), modules.unet.state_dict().values()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), k


def test_serve_the_student_through_cli_swap(one_round, tmp_path):
    """cli.swap --precropped --ckpt <out>/params.pt --ddim-steps 2 --scale
    1.0 loads the student (its UNet the student's weights rounded through
    --weights-dtype bfloat16) and writes the swap."""
    out, result, _ = one_round
    rng = np.random.default_rng(0)
    for name in ("src.png", "tgt.png"):
        imwrite(str(tmp_path / name), rng.integers(0, 255, (64, 64, 3), np.uint8))
    argv = ["--device", "cpu", "--tiny", "--precropped", "--ckpt", str(out / "params.pt"),
            "--ddim-steps", "2", "--scale", "1.0", "--source", str(tmp_path / "src.png"),
            "--target", str(tmp_path / "tgt.png"), "--outdir", str(tmp_path / "o")]
    cli_swap.main(argv)
    assert len(os.listdir(tmp_path / "o")) == 1
    swapper = cli_common.build_swapper(cli_swap.build_parser().parse_args(argv))
    assert swapper.config.ddim_steps == 2 and swapper.config.cfg_scale == 1.0
    student = result["modules"].unet.state_dict()
    for k, v in swapper.unet.state_dict().items():
        assert torch.equal(v.float(), student[k].to(torch.bfloat16).float()), k


def test_two_rounds_fold_then_unguided(tmp_path):
    """Teacher 4 -> target 1: the plan [2, 1]; round 0 folds CFG 3, round 1
    distils the round-0 student unguided; the manifest is the JAX driver's.
    --no-fold-cfg keeps CFG in every round and in the manifest, and
    --max-rounds cuts the plan."""
    out = tmp_path / "two"
    _, text = _run(["--out", str(out), "--target-steps", "1", "--steps-per-round", "1", *TINY])
    assert json.loads((out / "manifest.json").read_text()) == _manifest_jax(4, 1)
    assert "[distill] round 1: 2 -> 1 steps, cfg=1.0, fold=True" in text
    out = tmp_path / "nofold"
    _, text = _run(["--out", str(out), "--target-steps", "1", "--steps-per-round", "1",
                    "--no-fold-cfg", "--max-rounds", "1", *TINY])
    assert json.loads((out / "manifest.json").read_text()) == _manifest_jax(
        4, 1, fold=False, max_rounds=1)
    assert "[distill] round 0: 4 -> 2 steps, cfg=3.0, fold=False" in text
    assert "round 1" not in text


def test_teacher_ckpt_dtypes_and_refusals(tmp_path):
    """--teacher-ckpt reads the port's params file (the frozen towers and
    the teacher are its weights); --teacher-dtype bfloat16 stores the teacher
    in bf16 and --mu-dtype bfloat16 the first moment; an orbax directory is
    refused with the converter's name; without a card the default device
    raises."""
    modules = SwapModules(tiny_swap_config(64), "cpu")
    for i, m in enumerate(modules.towers().values()):
        init_params(m, seed=10 + i)
    path = tmp_path / "teacher.pt"
    save_swap_params(str(path), {n: m.state_dict() for n, m in modules.towers().items()})
    result, text = _run(["--out", str(tmp_path / "o"), "--target-steps", "2",
                         "--steps-per-round", "1", "--teacher-ckpt", str(path),
                         "--teacher-dtype", "bfloat16", "--mu-dtype", "bfloat16", *TINY])
    assert "WARNING: random teacher" not in text
    got = result["modules"]
    for name in ("vae", "conditioner"):
        ref = modules.towers()[name].state_dict()
        assert all(torch.equal(v.float(), ref[k].float())
                   for k, v in got.towers()[name].state_dict().items())
    from reface_tpu_torch.nn.layers import Conv2d, Linear

    layers = [m for m in result["teacher"].modules() if isinstance(m, (Conv2d, Linear))]
    assert {m.weight.dtype for m in layers} == {torch.bfloat16}
    with pytest.raises(SystemExit, match="jax_params_to_torch"):
        _run(["--out", str(tmp_path / "o2"), "--teacher-ckpt", str(tmp_path), *TINY])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _run(["--out", str(tmp_path / "o3"), "--tiny"])


def test_batches_dataset_and_synthetic(tmp_path):
    """The synthetic batches are the JAX driver's default_rng stream
    (uniform targets, the centre square masked, normal references); a
    CelebA-style tree feeds the loader's batches in the JAX layout, and a
    run on it trains."""
    args = cli_distill.build_parser().parse_args(["--out", "x", "--batch-size", "2",
                                                  "--image-size", "16", "--seed", "3"])
    gen = cli_distill._batches(args)
    rng = np.random.default_rng(3)
    for _ in range(2):
        got = next(gen)
        t = rng.uniform(-1, 1, (2, 16, 16, 3))
        m = np.ones((2, 16, 16, 1), np.float32)
        m[:, 4:-4, 4:-4] = 0.0
        ref = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
        np.testing.assert_array_equal(got["target_image"], t.astype(np.float32))
        np.testing.assert_array_equal(got["inpaint_image"], (t * m).astype(np.float32))
        np.testing.assert_array_equal(got["inpaint_mask"], m)
        np.testing.assert_array_equal(got["ref_clip224"], ref)
    tree = make_synthetic_celeba(str(tmp_path / "tree"), count=4, size=64)
    result, _ = _run(["--out", str(tmp_path / "o"), "--target-steps", "2",
                      "--steps-per-round", "2", "--dataset-dir", tree,
                      "--train-count", "4", *TINY])
    assert len(result["history"]) == 2 and all(np.isfinite(h["loss"]) for h in result["history"])
