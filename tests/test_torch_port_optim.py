"""The port's optimizer (AdamW with MultiSteps and clipping, pipelines/train.py)
against optax, its EMA against reface_tpu.core.ema and its LR schedules
against reface_tpu.core.lr_schedule, on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_helpers import one_torch_thread

from reface_tpu.core import ema as JE
from reface_tpu.core import lr_schedule as JL
from reface_tpu.pipelines import train as JT
from reface_tpu_torch.core import ema as PE
from reface_tpu_torch.core import lr_schedule as PL
from reface_tpu_torch.pipelines import train as PT

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------ flash attention


# ------------------------------------------------------------ the tiny step


# ------------------------------------------------------------ optimizer, EMA

_OPT_TREE = {
    "unet": {"w": (4, 3), "b": (5,)},
    "vae": {"w": (3,)},
    "conditioner": {"tower": {"w": (2,)}, "mapper2": {"w": (3, 2)},
                    "learnable_vector": (1, 1, 4)},
}
_OPT_NAMES = {
    ("unet", "w"): "unet.w", ("unet", "b"): "unet.b", ("vae", "w"): "vae.w",
    ("conditioner", "tower", "w"): "conditioner.cond_stage_model.model.w",
    ("conditioner", "mapper2", "w"): "conditioner.cond_stage_model.mapper2.w",
    ("conditioner", "learnable_vector"): "conditioner.learnable_vector",
}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(grad_clip=0.5),
    dict(grad_clip=1e3, mu_dtype="bfloat16"),
    dict(accumulate=2),
])
def test_optimizer_matches_optax(kw):
    """3 calls from the same gradients: the JAX make_optimizer (optax adamw
    with the linear warmup, weight decay on trainables only, clip_by_global_
    norm, MultiSteps, mu_dtype) against the port's AdamW, jitted as the JAX
    package's train step runs it. A large learning rate makes the updates a
    sizeable part of the parameters; 1e-6 relative L2 per leaf after every
    call."""
    cfg = dict(learning_rate=0.1, warmup_steps=2, **kw)
    rng = np.random.default_rng(len(kw))
    shapes = _flat(_OPT_TREE)
    init = {p: rng.normal(size=s).astype(np.float32) for p, s in shapes.items()}

    def nest(flat):
        tree = {}
        for path, v in flat.items():
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
        return tree

    j_params = jax.tree.map(jnp.asarray, nest(init))
    tx = JT.make_optimizer(JT.TrainConfig(**cfg), j_params)
    j_state, update = tx.init(j_params), jax.jit(tx.update)
    p_params = {_OPT_NAMES[p]: torch.from_numpy(a.copy()) for p, a in init.items()}
    opt = PT.make_optimizer(PT.TrainConfig(**cfg), p_params)
    assert sorted(opt.names) == sorted(n for n in p_params if not n.startswith(
        ("vae.", "conditioner.cond_stage_model.model.")))
    for _ in range(3):
        grads = {p: rng.normal(size=s).astype(np.float32) for p, s in shapes.items()}
        upd, j_state = update(jax.tree.map(jnp.asarray, nest(grads)), j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        by_name = {_OPT_NAMES[p]: g for p, g in grads.items()}
        opt.step([torch.from_numpy(by_name[n]) for n in opt.names])
        ref = _flat(jax.tree.map(np.asarray, j_params))
        for path, name in _OPT_NAMES.items():
            assert _rel(p_params[name].numpy(), ref[path]) <= 1e-6, (name, kw)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_ema_matches_jax(dtype):
    """Three ema_update calls with the warmup ramp, fp32 and bf16 shadows:
    within 1e-6 relative L2 of reface_tpu.core.ema (bf16: the same roundings
    of the same fp32 values)."""
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    j = JE.EmaState.create(jax.tree.map(jnp.asarray, params), decay=0.95,
                           dtype=dtype and jnp.bfloat16)
    p = PE.EmaState.create({k: torch.from_numpy(v) for k, v in params.items()},
                           decay=0.95, dtype=dtype and torch.bfloat16)
    for _ in range(3):
        params = {k: v + rng.normal(size=v.shape).astype(np.float32)
                  for k, v in params.items()}
        j = JE.ema_update(j, jax.tree.map(jnp.asarray, params))
        p = PE.ema_update(p, {k: torch.from_numpy(v) for k, v in params.items()})
        for k in params:
            assert _rel(p.shadow[k].float().numpy(),
                        np.asarray(j.shadow[k], np.float32)) <= 1e-6, k
    assert p.updates == int(j.updates) == 3


def test_lr_schedules_match_jax():
    """lambda_linear, lambda_warmup_cosine and scale_lr (1e-6 relative: the
    JAX package computes the schedules in fp32)."""
    jl, pl_ = JL.lambda_linear(100), PL.lambda_linear(100)
    jc = JL.lambda_warmup_cosine(10, 0.1, 1.0, 0.01, 50)
    pc = PL.lambda_warmup_cosine(10, 0.1, 1.0, 0.01, 50)
    for step in (0, 1, 50, 99, 100, 10**6):
        np.testing.assert_allclose(pl_(step), float(jl(step)), rtol=1e-6)
    for step in (0, 5, 10, 30, 50, 80):
        np.testing.assert_allclose(pc(step), float(jc(step)), rtol=1e-6)
    assert PL.scale_lr(1e-5, 4, 8, 2) == JL.scale_lr(1e-5, 4, 8, 2)
