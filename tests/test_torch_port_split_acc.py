"""TrainConfig.split_acc_dtype (reface_tpu_torch/pipelines/train.py) on the
CPU, at the tiny full-loss config of test_torch_port_losses.py.

"bfloat16" leaves the recon portion's gradient in .grad rounded to bf16
before the eps portion's backward adds onto it, as the JAX split step holds
it (reface_tpu/pipelines/train.py: _filter_frozen's cast, then
ge + gr.astype(ge.dtype)). At split_grad 1 the fp32 gradient is rounded
once; at split_grad 2 the pullback is taken with respect to the trainable
weights in bf16, so each use's contribution is rounded and the sum over the
chain's steps is carried in bf16, as the JAX step's pre-cast bf16 tree
carries it.

Here: the step is the sum of the eps portion and the recon portion's
backward (train_step.recon_backward), and that backward is held to its
definition at level 1 and to the JAX step's own level-2 pullback (its
"pull" program, given the same cotangents as the port's). Level 1 against
the JAX step is in test_torch_port_split_acc_jax.py.

The LPIPS term is off (its tower adds time, not a path: the ID loss alone
makes the step split).

Tolerances (relative L2 over all trainable tensors): the step against eps +
recon, 1e-6 (fp32 summation order; seen 0); level 1's recon part against the
fp32 recon portion rounded to bf16, 1e-6 (seen 0), and off the fp32 one by
more than 1e-5 (seen 1.7e-3 at level 1, 2.1e-2 at level 2); level 2's
against JAX's pull, 1e-3 (each side rounds fp32 contributions that differ in
their last bits, and sums them in bf16 in its own order; seen 7.2e-5), and
the fp32 pullback must be further than 1e-3 from JAX's bf16 one (seen
2.1e-2), so that the bf16 carry shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import RECON_KW, full_loss_setup, jax_draws, one_torch_thread, port_full_step

from reface_tpu.diffusion.losses import ReconLossConfig
from reface_tpu.pipelines import train as JT
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.pipelines import train as PT
from reface_tpu_torch.pipelines.swap import tiny_swap_config

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

RECON = dict(lpips_weight=0.0)  # the ID loss alone still splits the step; LPIPS costs time


@pytest.fixture(scope="module")
def setup():
    jcfg, params, batch, key = full_loss_setup()
    params = {k: v for k, v in params.items() if k not in ("landmark_head", "lpips")}
    return (from_jax.swap_from_jax(params), batch, jax_draws(key, 2, 8, JT.TrainConfig()),
            (jcfg, params, key))


def _grads(modules) -> dict:
    return {k: p.grad.clone() for k, p in PT.named_params(modules).items()
            if p.grad is not None}


def _rel(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    num = sum(float((a[k] - b[k]).double().pow(2).sum()) for k in b)
    return (num / sum(float(v.double().pow(2).sum()) for v in b.values())) ** 0.5


def _plus(eps: dict, recon: dict) -> dict:
    """eps + recon, leaf by leaf (a leaf without a gradient in one portion
    counts as zeros there)."""
    out = dict(eps)
    for k, g in recon.items():
        out[k] = out[k] + g if k in out else g
    return out


def _step(params, level, acc):
    return port_full_step(params, PT.TrainConfig(split_grad=level, split_acc_dtype=acc),
                          **RECON)


def _clear(modules):
    for p in PT.named_params(modules).values():
        p.grad = None


def _recon_part(params, batch, draws, level, acc) -> dict:
    step, _, state = _step(params, level, acc)
    _clear(state.modules)
    step.recon_backward(state.modules, batch, draws)
    return _grads(state.modules)


@pytest.mark.parametrize("level", [1, 2])
def test_bf16_accumulator_matches_its_definition(setup, level):
    params, batch, draws, _ = setup
    step, loss_fn, state = _step(params, level, "bfloat16")
    before = {k: p.detach().clone() for k, p in PT.named_params(state.modules).items()}
    step.loss_and_grads(state.modules, batch, draws)
    after = PT.named_params(state.modules)
    assert all(after[k].dtype == torch.float32 and torch.equal(after[k], v)
               for k, v in before.items())  # the fp32 weights come back as they were
    got = _grads(state.modules)
    assert all(g.dtype == torch.float32 for g in got.values())

    _clear(state.modules)
    loss_fn(state.modules, batch, draws, portion="eps")[0].backward()
    eps = _grads(state.modules)
    recon = _recon_part(params, batch, draws, level, "bfloat16")
    assert all(torch.equal(g, g.to(torch.bfloat16).float()) for g in recon.values())
    assert _rel(got, _plus(eps, recon)) <= 1e-6
    f32 = _recon_part(params, batch, draws, level, "float32")
    if level == 1:
        assert _rel(recon, {k: g.to(torch.bfloat16).float() for k, g in f32.items()}) <= 1e-6
    assert _rel(recon, f32) > 1e-5  # the rounding shows


def test_bf16_pullback_matches_jax(setup):
    """split_grad=2's recon part against the JAX step's "pull" program
    (split_grad=2, split_acc_dtype="bfloat16"), both given the port's
    cotangents of the collected latents."""
    params, batch, draws, (jcfg, jparams, key) = setup
    step, _, state = _step(params, 2, "bfloat16")
    _clear(state.modules)
    _, _, latents, cots = step.recon_cotangents(state.modules, batch, draws)
    shapes = [tuple(x.permute(0, 2, 3, 1).shape) for x in latents]
    del latents
    _clear(state.modules)
    step.recon_backward(state.modules, batch, draws)
    got = _grads(state.modules)
    f32 = _recon_part(params, batch, draws, 2, "float32")

    j_step, _, _ = JT.make_train_step(
        jcfg, JT.TrainConfig(split_grad=2, split_acc_dtype="bfloat16"),
        recon=ReconLossConfig(**RECON_KW, **RECON))
    given = dict((i, g.permute(0, 2, 3, 1).numpy()) for i, g in cots)
    j_cots = [jnp.asarray(given[i]) if i in given else jnp.zeros(s, jnp.float32)
              for i, s in enumerate(shapes)]
    j_grads = j_step.programs["pull"](jparams, batch, key, j_cots)
    assert {str(g.dtype) for g in jax.tree.leaves(j_grads) if g.ndim} == {"bfloat16"}
    full = jax.tree.map(lambda g, p: np.asarray(g, np.float32) if g.shape == p.shape
                        else np.zeros(p.shape, np.float32), j_grads, jparams)
    ref = {f"{tower}.{k}": v for tower, sd in from_jax.swap_from_jax(full).items()
           for k, v in sd.items()}
    assert not any(v.any() for k, v in ref.items() if k not in got)
    ref = {k: ref[k] for k in got}
    assert _rel(got, ref) <= 1e-3
    assert _rel(f32, ref) > 1e-3


def test_split_acc_dtype_refuses_other_dtypes():
    with pytest.raises(ValueError, match="split_acc_dtype"):
        PT.make_train_step(tiny_swap_config(64), PT.TrainConfig(split_acc_dtype="float16"),
                           device="cpu")
