"""The port's training driver (reface_tpu_torch/cli/train.py) against the
JAX package's, on the CPU, at the tiny config.

The driver parity test runs both drivers on the same synthetic tree and
flags. Their draws differ, so their losses do too, and the real validation
losses would order the top-k checkpoints differently: both drivers are fed
the same validation losses (make_train_step's loss function wrapped), and
the JAX driver's step is replaced by one that only counts (its jit alone
takes ~90 s here) and reports metrics under the keys jax.eval_shape gives
its real step; its mesh is one device, as the port's driver runs; its
weights are zeros of the init's shapes and its checkpoints empty
directories (only their tags are compared). The port's step is its own. Compared: the checkpoint tags,
the top-k pruning, metrics.jsonl's keys and step/epoch values, and the
learning rate of each step (the port's timing.jsonl against the JAX
driver's TrainConfig through optax's schedule: 1e-6 relative, and one fp32
ulp of the peak rate absolute, the cancellation in optax's fp32
init - end + end at the first step).

Then the full resume from the port's run and the params-only fallback.
The checkpoints' round trip, the signal and crash checkpoints, the
refusals and the LPIPS reader are in test_torch_port_cli_train_state.py,
TrainConfig.split_acc_dtype in test_torch_port_split_acc.py.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import io_callback

from test_torch_port_helpers import one_torch_thread

import reface_tpu.ckpt.io as JIO
import reface_tpu.parallel as JP
import reface_tpu.pipelines.swap as JSwap
import reface_tpu.pipelines.train as JT
from reface_tpu.cli import train as jax_cli_train
from reface_tpu.data.synthetic import make_synthetic_celeba as jax_make_celeba
from reface_tpu_torch.cli import train as cli_train
from reface_tpu_torch.data.synthetic import make_synthetic_celeba
from reface_tpu_torch.pipelines import train as PT

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

VAL_LOSSES = (0.9, 0.7)  # fed to both drivers' validations, in order
FLAGS = ["--tiny", "--image-size", "64", "--train-count", "4", "--batch-size", "2",
         "--steps", "4", "--log-every", "1", "--image-log-every", "2", "--val-every", "2",
         "--val-count", "2", "--keep-top-k", "1", "--ckpt-every", "2", "--warmup-steps", "3"]


def _val_feed(as_array):
    """A loss function that returns VAL_LOSSES in turn, one per batch (for
    the JAX driver, whose loss function is jitted, through a host callback)."""
    it = iter(VAL_LOSSES * 4)
    if as_array is torch.tensor:
        return lambda *a, **kw: (torch.tensor(next(it)), {})
    shape = jax.ShapeDtypeStruct((), jnp.float32)
    return lambda *a, **kw: (io_callback(lambda: np.float32(next(it)), shape), {})


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_tree")
    return make_synthetic_celeba(str(root / "celeba"), count=6, size=64, seed=0)


@pytest.fixture(scope="module")
def port_run(tree, tmp_path_factory):
    """The port's tiny driver with EMA: (logdir, final state). Its two full
    checkpoints (~0.5 GB each) are deleted after the module."""
    logdir = str(tmp_path_factory.mktemp("port_run"))
    real = PT.make_train_step

    def make(*a, **kw):
        step_fn, loss_fn, init_state = real(*a, **kw)
        return step_fn, _val_feed(torch.tensor), init_state

    PT.make_train_step = make
    try:
        state = cli_train.main(["--device", "cpu", "--dataset-dir", tree, "--logdir", logdir,
                                "--ema-decay", "0.99", *FLAGS])
    finally:
        PT.make_train_step = real
    yield logdir, state
    shutil.rmtree(os.path.join(logdir, "checkpoints"))


def _read(logdir, name):
    with open(os.path.join(logdir, name)) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_tiny_cli_train_matches_jax_driver(tree, port_run, tmp_path, monkeypatch):
    jax_tree = jax_make_celeba(str(tmp_path / "jax_tree"), count=6, size=64, seed=0)
    seen = {}
    real = JT.make_train_step

    def make(swap_cfg, train_cfg, recon=None):
        step_fn, loss_fn, init_state = real(swap_cfg, train_cfg, recon=recon)
        seen["cfg"] = train_cfg

        def step(state, batch, key):
            if "keys" not in seen:  # the real step's metrics, traced only
                _, m = jax.eval_shape(step_fn, state, batch, key)
                seen["keys"] = sorted(m)
            metrics = {k: jnp.float32(0.5) for k in seen["keys"]}
            return JT.TrainState(state.params, state.opt_state, state.step + 1,
                                 state.ema), metrics

        return step, _val_feed(jnp.float32), init_state

    monkeypatch.setattr(JT, "make_train_step", make)
    # the tags are compared, not the JAX files: its checkpoints are empty
    # directories, and its (unused) weights zeros of the init's shapes
    monkeypatch.setattr(JIO, "save_train_state", lambda path, *a: os.makedirs(path))
    init = JSwap.FaceSwapper.init_params
    monkeypatch.setattr(JSwap.FaceSwapper, "init_params", staticmethod(
        lambda cfg, key: jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                                      jax.eval_shape(lambda k: init(cfg, k), key))))
    # one device, as the port's driver runs (the suite's JAX has 8 host devices)
    real_mesh = JP.create_mesh
    monkeypatch.setattr(JP, "create_mesh", lambda: real_mesh(devices=jax.devices()[:1]))
    jax_log = str(tmp_path / "jax_log")
    jax_cli_train.main(["--backend", "cpu", "--dataset-dir", jax_tree, "--logdir", jax_log,
                        *FLAGS])
    port_log, state = port_run
    assert state.step == 4
    tags = lambda d: sorted(os.listdir(os.path.join(d, "checkpoints")))
    assert tags(port_log) == tags(jax_log)
    assert sum(t.startswith("best_") for t in tags(port_log)) == 1  # best_2 pruned
    assert sorted(os.listdir(os.path.join(port_log, "images"))) == \
        sorted(os.listdir(os.path.join(jax_log, "images")))
    pm, jm = _read(port_log, "metrics.jsonl"), _read(jax_log, "metrics.jsonl")
    assert [sorted(m) for m in pm] == [sorted(m) for m in jm]
    for p, j in zip(pm, jm):
        assert {k: p[k] for k in ("step", "epoch", "val_loss") if k in p} == \
            {k: j[k] for k in ("step", "epoch", "val_loss") if k in j}
    cfg = seen["cfg"]
    sched = optax.linear_schedule(cfg.learning_rate * 1e-6, cfg.learning_rate,
                                  cfg.warmup_steps)
    port_lr = [r["lr"] for r in _read(port_log, "timing.jsonl") if "lr" in r]
    np.testing.assert_allclose(port_lr, [float(sched(c)) for c in range(4)], rtol=1e-6,
                               atol=cfg.learning_rate * 2**-23)
    assert cfg.learning_rate == 1e-5 * 2  # base_lr x batch


def test_resume_full_then_params_only(tree, port_run, tmp_path, capsys):
    """--resume of a checkpoint directory restores the full state (step 2 ->
    ends at 4); with another --ema-decay the full resume fails and the
    params-only fallback restarts at step 0 with the checkpoint's weights."""
    logdir, _ = port_run
    ck = os.path.join(logdir, "checkpoints", "step_00000002")
    base = ["--device", "cpu", "--dataset-dir", tree, "--tiny", "--image-size", "64",
            "--train-count", "4", "--batch-size", "2", "--no-final-ckpt"]
    state = cli_train.main(base + ["--logdir", str(tmp_path / "a"), "--ema-decay", "0.99",
                                   "--resume", ck, "--steps", "3"])
    out = capsys.readouterr().out
    assert f"resumed FULL train state at step 2 from {ck}" in out
    assert state.step == 3
    state = cli_train.main(base + ["--logdir", str(tmp_path / "b"), "--resume", ck,
                                   "--steps", "1"])
    out = capsys.readouterr().out
    assert "WARNING: full-state resume failed" in out
    assert f"resumed params only from {ck}" in out
    assert state.step == 1 and state.ema is None and state.opt.count == 1
