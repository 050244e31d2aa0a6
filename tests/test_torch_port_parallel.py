"""The port's parallel runtime (reface_tpu_torch.parallel) on the CPU.

- unet_tp_spec against the JAX unet_tp_spec, leaf by leaf through
  ckpt/from_jax's name mapping and layouts, on the tiny UNet and on the full
  UNetConfig() (built on the meta device: 859,535,364 parameters) for 2-,
  4- and 8-way TP with the JAX placement's rule for a dim the axis does not
  divide.
- The loader's process slices against the JAX loader's, for 2 and 4
  processes.
- Two gloo ranks spawned on a file store (tests/torch_port_parallel_ranks.py)
  run one data-parallel step (2 x 1 mesh, batch 2 a rank) and one
  tensor-parallel step (1 x 2, the whole batch on both) against the
  one-process step on the same global batch of 4, the same params and the
  same draws: the loss within 1e-6 relative, every gradient and every
  updated parameter within 1e-5 relative L2 (fp32; only the summation order
  of the batch and of the row-parallel products moves), the clip's global
  norm within 1e-6 (under TP the sharded leaves' squares summed over the
  model group). The UNet is a small config where a conv, a self-attention
  and a GEGLU shard; the step's learning rate moves the weights well above
  their rounding, behind a clip that engages.
- The same two ranks first run cli.train --device cpu --tiny at
  --batch-size 1 (joining the group from the driver's flags), against one
  process at --batch-size 2 (the same world batch and LR), 2 steps:
  metrics.jsonl and the params file within 1e-5 (relative; per tensor,
  relative L2 of the larger of its norm and 1e-3 of its tower's: a
  zero-initialised bias holds only its first updates, whose signs follow
  gradients at rounding level), and rank 1 writes nothing.
- The one-process mesh.

The 2 x 2 step against the JAX mesh step is in
test_torch_port_parallel_jax.py.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_parallel_ranks as R
from torch_port_parallel_ranks import SMALL
from test_torch_port_helpers import PORT_NICE, one_torch_thread, train_batch

from reface_tpu.data import PrefetchLoader as JLoader
from reface_tpu.nn.unet import UNetConfig as JUNetConfig
from reface_tpu.nn.unet import UNetModel as JUNet
from reface_tpu.parallel.tp import unet_tp_spec as j_spec
from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.ckpt import io as ckpt_io
from reface_tpu_torch.cli import train as cli_train
from reface_tpu_torch.data import PrefetchLoader
from reface_tpu_torch.data.synthetic import make_synthetic_celeba
from reface_tpu_torch.nn.unet import UNetConfig, UNetModel
from reface_tpu_torch.parallel import create_mesh, init_distributed, shard_batch, shard_params
from reface_tpu_torch.parallel.tp import tp_dim, unet_tp_spec
from reface_tpu_torch.pipelines import train as PT
from reface_tpu_torch.pipelines.swap import init_params
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)



# ------------------------------------------------------------ the TP rule

def test_unet_tp_spec_rules():
    """tests/test_parallel.py's cases on the torch names and layouts."""
    assert unet_tp_spec("x.attn1.to_q.weight", (320, 320)) == ("model", None)
    assert unet_tp_spec("x.attn1.to_out.0.weight", (320, 320)) == (None, "model")
    assert unet_tp_spec("x.in_layers.2.weight", (320, 320, 3, 3)) == ("model", None, None, None)
    assert unet_tp_spec("x.norm.weight", (320,)) == ()
    assert unet_tp_spec("x.in_layers.2.weight", (32, 9, 3, 3)) == ()  # small convs
    assert unet_tp_spec("x.ff.net.0.proj.weight", (2560, 320)) == ("model", None)
    assert unet_tp_spec("x.ff.net.2.weight", (320, 1280)) == (None, "model")
    assert unet_tp_spec("x.proj_out.weight", (320, 320, 1, 1)) == ("model", None, None, None)
    assert tp_dim("x.attn1.to_q.weight", (320, 320), 3) is None  # not divisible


@functools.lru_cache(maxsize=None)
def _jax_unet_leaves(cfg):
    """(torch name, torch shape, the JAX spec in torch layout) per leaf of the
    JAX UNet's params, through from_jax's rule."""
    shapes = jax.eval_shape(
        JUNet(cfg).init, jax.random.key(0), jnp.zeros((1, 8, 8, 9)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, cfg.context_dim)))["params"]
    out = []
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        name, fn = from_jax._unet_rule(list(keys))
        spec = tuple(j_spec(keys, s.shape))
        tshape = fn(np.zeros(s.shape, np.int8)).shape
        # the sharded JAX dim in the torch layout: a Dense kernel (in, out)
        # transposes, a conv kernel HWIO goes to OIHW
        dim = None
        if "model" in spec:
            jdim = spec.index("model")
            dim = {2: {0: 1, 1: 0}, 4: {3: 0, 2: 1}}[len(s.shape)][jdim]
        out.append((name, tuple(tshape), s.shape, dim))
    return out


def _check_rule(cfg_j, cfg_p, ways):
    leaves = _jax_unet_leaves(cfg_j)
    port = {k: tuple(p.shape) for k, p in UNetModel(cfg_p, device="meta").named_parameters()}
    assert {n for n, *_ in leaves} == set(port)
    sharded = 0
    for name, tshape, jshape, dim in leaves:
        assert port[name] == tshape, name
        spec = unet_tp_spec(name, tshape)
        assert (spec.index("model") if "model" in spec else None) == dim, name
        for n in ways:
            # the JAX placement replicates what the axis does not divide
            want = dim if dim is not None and tshape[dim] % n == 0 else None
            assert tp_dim(name, tshape, n) == want, (name, n)
        sharded += int(np.prod(tshape)) if dim is not None else 0
    return sharded, sum(int(np.prod(s)) for s in port.values())


def test_unet_tp_spec_matches_jax_tiny():
    sharded, _ = _check_rule(j_tiny(64).unet, p_tiny(64).unet, (2, 3, 4))
    assert sharded > 0


@pytest.mark.parametrize("ways", [2, 4, 8])
def test_unet_tp_spec_matches_jax_full(ways):
    """The full UNet: the same decision on every leaf, every sharded dim
    divisible (tests/test_parallel.py's real-size check), most of the net
    sharded."""
    sharded, total = _check_rule(JUNetConfig(), UNetConfig(), (ways,))
    assert total == 859_535_364
    assert sharded / total > 0.8
    for name, p in UNetModel(UNetConfig(), device="meta").named_parameters():
        spec = unet_tp_spec(name, p.shape)
        if "model" in spec:
            assert tp_dim(name, p.shape, ways) is not None, (name, ways)


# ------------------------------------------------------------ the loader

class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array(i)}


@pytest.mark.parametrize("count", [2, 4])
def test_loader_slices_match_jax(count):
    """Each process's batches (shuffled, two epochs, the ragged last batch
    dropped) equal the JAX loader's; together they are the one-process
    loader's."""
    whole = PrefetchLoader(_Items(22), batch_size=8, shuffle=True, seed=3, num_workers=2)
    full = [[b["i"].tolist() for b in whole] for _ in range(2)]
    parts = []
    for index in range(count):
        kw = dict(batch_size=8, shuffle=True, seed=3, num_workers=2,
                  process_index=index, process_count=count)
        port, jx = PrefetchLoader(_Items(22), **kw), JLoader(_Items(22), **kw)
        got = [[b["i"].tolist() for b in port] for _ in range(2)]
        assert got == [[b["i"].tolist() for b in jx] for _ in range(2)]
        parts.append(got)
    for e in range(2):
        assert len(full[e]) == 2
        for b in range(2):
            assert sum((p[e][b] for p in parts), []) == full[e][b]


# ------------------------------------------------------------ the steps

# cli.train's flags on both sides (the world batch 2: --batch-size 2 on one
# process, 1 on each of two)
CLI_ARGV = ["--device", "cpu", "--tiny", "--image-size", "64", "--train-count", "4",
            "--steps", "2", "--log-every", "1"]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The one-process step and the two ranks' cli.train run, DP step and TP
    step, from one set of params (seeded, zero-initialised layers
    re-randomised), one batch of 4 and one set of draws with a dropped and
    a kept sample; the ranks' tmp directory and the CelebA-style tree."""
    tmp = tmp_path_factory.mktemp("parallel_steps")
    tree = make_synthetic_celeba(str(tmp / "celeba"), count=6, size=64, seed=0)
    modules = PT.TrainModules(R.step_config(SMALL), "cpu")
    for i, m in enumerate(modules.towers().values()):
        init_params(m, seed=i, dezero=True)
    params = {n: m.state_dict() for n, m in modules.towers().items()}
    batch = train_batch(b=4)
    draws = {k: v.numpy() for k, v in PT.make_draws(
        4, 8, PT.TrainConfig(), "cpu", torch.Generator().manual_seed(5)).items()}
    draws["drop"][:2] = [True, False]
    torch.save({"params": params, "batch": batch, "draws": draws}, tmp / "inputs.pt")
    ref = R.one_step(None, SMALL, params, batch, draws)
    R.spawn(2, tmp, PORT_NICE, meshes=[("dp", 2, 1), ("tp", 1, 2)], cfg_kw=SMALL,
            cli_argv=[*CLI_ARGV, "--dataset-dir", tree, "--batch-size", "1"])
    return ref, {k: torch.load(tmp / f"{k}.pt", weights_only=False) for k in ("dp", "tp")}, \
        tmp, tree


def _check_step(got, ref):
    assert abs(got["loss"] / ref["loss"] - 1) < 1e-6
    assert ref["grad_norm"] > R.STEP_TCFG["grad_clip"]  # the clip engages
    assert abs(got["grad_norm"] / ref["grad_norm"] - 1) < 1e-6
    assert got["metrics"].keys() == ref["metrics"].keys()
    assert set(got["grads"]) == set(ref["grads"]) and set(got["params"]) == set(ref["params"])
    n_grads = 0
    for name, g in ref["grads"].items():
        assert (got["grads"][name] is None) == (g is None), name
        if g is not None:
            assert got["grads"][name].shape == g.shape, name
            assert R.rel_l2(got["grads"][name], g) < 1e-5, name
            n_grads += 1
    assert n_grads > 100
    for name, p in ref["params"].items():
        assert got["params"][name].shape == p.shape, name
        assert R.rel_l2(got["params"][name], p) < 1e-5, name


def test_dp_step_matches_one_process(steps):
    ref, got, *_ = steps
    _check_step(got["dp"], ref)


def test_tp_step_matches_one_process(steps):
    """Gathered gradients and parameters (gather_params_tp) of the 2-way TP
    step; a conv, a self-attention (on its local heads) and a GEGLU shard."""
    ref, got, *_ = steps
    assert got["tp"]["sharded"] == {"conv": True, "self_attention": True, "geglu": True}
    _check_step(got["tp"], ref)


def test_cli_train_two_processes_match_one(steps, tmp_path, monkeypatch):
    _, _, ranks_dir, tree = steps
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    cli_train.main([*CLI_ARGV, "--dataset-dir", tree, "--batch-size", "2",
                    "--logdir", str(tmp_path / "one")])
    assert not os.path.exists(ranks_dir / "rank1")

    def metrics(d):
        with open(d / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    one, two = metrics(tmp_path / "one"), metrics(ranks_dir / "rank0")
    assert len(one) == len(two) == 2
    for a, b in zip(one, two):
        assert a.keys() == b.keys() and a["step"] == b["step"]
        for k in a:
            if k not in ("sps", "step", "epoch"):
                assert abs(b[k] - a[k]) <= 1e-5 * abs(a[k]), k
    p_one = ckpt_io.load_params(str(tmp_path / "one" / "checkpoints" / "last"))
    p_two = ckpt_io.load_params(str(ranks_dir / "rank0" / "checkpoints" / "last"))
    assert p_one.keys() == p_two.keys()
    for tower in p_one:
        assert p_one[tower].keys() == p_two[tower].keys()
        whole = np.sqrt(sum(float(v.double().norm()) ** 2 for v in p_one[tower].values()))
        for k, v in p_one[tower].items():
            diff = float((p_two[tower][k].double() - v.double()).norm())
            assert diff <= 1e-5 * max(float(v.double().norm()), 1e-3 * whole), (tower, k)


def test_one_process_mesh(monkeypatch):
    """Without a coordinator or torchrun's environment: no group, a 1 x 1
    mesh, the JAX error text for a mesh the world does not fill, the batch
    moved to the device, the params left alone."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() == (0, 1)
    assert init_distributed(num_processes=1, process_id=0) == (0, 1)
    mesh = create_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_group is None
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        create_mesh(n_data=2)
    out = shard_batch({"a": np.ones((2, 3), np.float32), "b": {"c": torch.zeros(1)}}, mesh)
    assert out["a"].device.type == "cpu" and out["a"].shape == (2, 3)
    lin = torch.nn.Linear(2, 2)
    before = lin.weight.clone()
    assert shard_params(lin, mesh) is lin
    assert torch.equal(lin.weight, before)
