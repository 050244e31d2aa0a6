"""The training driver's checkpoints and guards on the CPU, at the tiny
config: ckpt/io.py's full train state round trip (bit-equal), SIGUSR1's
on-demand checkpoint and the crash checkpoint of cli/train.py, its refusals
(no card under --device cuda, a multi-process request), the hard-linked
save at an unchanged step and its fallback, core/profiling.py on the CPU
(also for a CPU device where a card is present), and
ckpt/from_torch.lpips_state_dict against the JAX
convert_lpips on both of its layouts (equal tensors). The driver against
the JAX driver, and its resume, are in test_torch_port_cli_train.py.
"""

import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import one_torch_thread

from reface_tpu.ckpt.convert import convert_lpips
from reface_tpu.nn.lpips import LPIPS as JLPIPS
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.ckpt import io as ckpt_io
from reface_tpu_torch.ckpt.from_torch import lpips_state_dict
from reface_tpu_torch.core.profiling import StepTimer, device_memory_stats, trace
from reface_tpu_torch.cli import train as cli_train
from reface_tpu_torch.data.synthetic import make_synthetic_celeba
from reface_tpu_torch.nn.lpips import LPIPS
from reface_tpu_torch.pipelines import train as PT
from reface_tpu_torch.pipelines.swap import init_params, tiny_swap_config

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_tree")
    return make_synthetic_celeba(str(root / "celeba"), count=6, size=64, seed=0)


def _tiny_state(seed, **tcfg):
    step, _, init_state = PT.make_train_step(tiny_swap_config(64), PT.TrainConfig(**tcfg),
                                             device="cpu")
    return step, init_state(seed=seed)


def _batch(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    return {"target_image": img, "inpaint_image": img * 0.5,
            "inpaint_mask": (rng.random((2, 64, 64, 1)) > 0.5).astype(np.float32),
            "ref_clip224": rng.normal(size=(2, 224, 224, 3)).astype(np.float32)}


def _tensors(state) -> dict:
    out = {f"{t}.{k}": v for t, m in state.modules.towers().items()
           for k, v in m.state_dict().items()}
    for key in ("mu", "nu", "acc"):
        out.update({f"{key}.{n}": v for n, v in zip(state.opt.names, getattr(state.opt, key))})
    out.update({f"ema.{k}": v for k, v in state.ema.shadow.items()})
    return out


def test_train_state_round_trip_bit_equal(tmp_path):
    """save_train_state then load_train_state into a differently seeded state
    of the same config: every tensor (towers, mu, nu, the MultiSteps
    accumulator, the EMA shadow) and counter bit-equal."""
    kw = dict(ema_decay=0.99, accumulate=2, warmup_steps=2)
    step, state = _tiny_state(0, **kw)
    g = torch.Generator().manual_seed(0)
    for i in range(3):
        state, _ = step(state, _batch(i), generator=g)
    ckpt_io.save_train_state(str(tmp_path / "ck"), state)
    _, other = _tiny_state(1, **kw)
    ckpt_io.load_train_state(str(tmp_path / "ck"), other)
    want, got = _tensors(state), _tensors(other)
    assert want.keys() == got.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert (other.step, other.opt.count, other.opt.mini_step, other.ema.updates) == \
        (state.step, state.opt.count, state.opt.mini_step, state.ema.updates) == (3, 1, 1, 3)
    with open(tmp_path / "ck" / "reface_meta.json") as f:
        assert json.load(f) == {"step": 3}
    shutil.rmtree(tmp_path / "ck")  # ~0.5 GB


def test_sigusr1_and_crash_last(tree, tmp_path, monkeypatch):
    """SIGUSR1 during a step writes sig_<step> after it; an exception in a
    step writes crash_last and propagates."""
    real = PT.make_train_step
    calls = {"n": 0}

    def make(*a, **kw):
        step_fn, loss_fn, init_state = real(*a, **kw)

        def step(state, batch, **kw2):
            calls["n"] += 1
            if calls["n"] == 1:
                os.kill(os.getpid(), signal.SIGUSR1)
            if calls["n"] == 3:
                raise RuntimeError("step failed")
            return step_fn(state, batch, **kw2)

        return step, loss_fn, init_state

    monkeypatch.setattr(PT, "make_train_step", make)
    with pytest.raises(RuntimeError, match="step failed"):
        cli_train.main(["--device", "cpu", "--dataset-dir", tree, "--logdir", str(tmp_path),
                        "--tiny", "--image-size", "64", "--train-count", "4",
                        "--batch-size", "2", "--steps", "5"])
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["crash_last", "sig_00000001"]
    assert os.path.exists(tmp_path / "checkpoints" / "crash_last" / ckpt_io.STATE_FILE)
    shutil.rmtree(tmp_path / "checkpoints")  # ~1 GB


def test_device_cuda_raises_without_card(tree, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--dataset-dir", tree, "--logdir", str(tmp_path), "--tiny"])


@pytest.mark.parametrize("flags", [["--num-processes", "2"], ["--process-id", "1"],
                                   ["--coordinator", "localhost:1234"]])
def test_multiprocess_request_raises(tree, tmp_path, flags):
    with pytest.raises(SystemExit, match="A15"):
        cli_train.main(["--device", "cpu", "--dataset-dir", tree, "--logdir", str(tmp_path),
                        "--tiny", *flags])


@pytest.mark.parametrize("layout", ["module_dump", "alexnet_and_lin"])
def test_lpips_state_dict_matches_convert_lpips(layout):
    """Both layouts the JAX convert_lpips reads: the reference LPIPS module
    dump, and torchvision's AlexNet (with its classifier) merged with the
    official lin calibration (`lin{i}.model.1.weight`); equal tensors."""
    sd = init_params(LPIPS(), seed=3).state_dict()
    if layout == "alexnet_and_lin":
        sd = {**{k.replace("net.layers.", "features."): v for k, v in sd.items()
                 if k.startswith("net.")},
              **{f"lin{k.split('.')[1]}.model.1.weight": v for k, v in sd.items()
                 if k.startswith("lin.")},
              "classifier.1.weight": torch.zeros(4096, 9216)}
    x0 = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(JLPIPS().init, jax.random.key(1), x0, x0)
    ref = from_jax.lpips_from_jax(convert_lpips(shapes, {k: v.numpy() for k, v in sd.items()}))
    got = lpips_state_dict(sd)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(got[k], torch.as_tensor(np.asarray(v))), k


def test_profiling_on_the_cpu(tmp_path):
    """core/profiling.py without a card: StepTimer's steps/s at its sample
    points, a Chrome trace written under the directory, no memory stats."""
    timer = StepTimer(sync_every=2)
    timer.start()
    assert timer.step() is None
    sps = timer.step()
    assert sps is not None and sps > 0 and timer.history == [sps]
    with trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert device_memory_stats() == {}


def test_memory_stats_of_a_cpu_device_with_a_card(monkeypatch):
    """--device cpu on a machine with a card: the driver's memory stats of
    its CPU device are empty, not a query of the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device_memory_stats("cpu") == {}
    assert device_memory_stats(torch.device("cpu")) == {}


def test_link_checkpoint_falls_back(tmp_path, monkeypatch):
    """A save at an unchanged step links the last save's files; where the
    source is gone or the filesystem refuses hard links, nothing is left at
    the destination and the caller saves in full."""
    src = tmp_path / "step_00000002"
    src.mkdir()
    for name in (ckpt_io.PARAMS_FILE, ckpt_io.STATE_FILE):
        (src / name).write_bytes(b"x" * 8)
    assert cli_train.link_checkpoint(str(src), str(tmp_path / "best"))
    assert sorted(os.listdir(tmp_path / "best")) == sorted(os.listdir(src))
    assert os.path.samefile(tmp_path / "best" / ckpt_io.STATE_FILE, src / ckpt_io.STATE_FILE)
    assert not cli_train.link_checkpoint(str(tmp_path / "gone"), str(tmp_path / "a"))
    assert not cli_train.link_checkpoint(None, str(tmp_path / "a"))

    def refuse(*a):
        raise OSError(1, "Operation not permitted")

    monkeypatch.setattr(os, "link", refuse)
    assert not cli_train.link_checkpoint(str(src), str(tmp_path / "last"))
    assert not os.path.exists(tmp_path / "last")
