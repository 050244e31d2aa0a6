"""TrainConfig.split_acc_dtype="bfloat16" at split_grad=1 against the JAX
split step, on the CPU, at the tiny full-loss config of
test_torch_port_split_acc.py (the LPIPS term off).

The JAX step (reface_tpu/pipelines/train.py, split_grad=1) takes the recon
portion's value_and_grad in one program and casts its trainable gradients
to the accumulator's dtype (_filter_frozen) before it adds them to the eps
portion's. Here that program is jitted as the step jits it and the cast is
the step's; the port's recon part (train_step.recon_backward, the .grad
that the eps portion's backward then adds onto) is held to it. That the
port's step is that part plus the eps portion's fp32 gradient is
test_torch_port_split_acc.py's; the eps portion against JAX is
test_torch_port_train.py's (a jit of the JAX eps gradient would add ~22 s
to this file).

Tolerances (relative L2 over all trainable tensors): the recon loss within
1e-5 relative; the recon part within 5e-4 of JAX's bf16 one (the two fp32
gradients differ in their last bits, so some elements round to the other
bf16 neighbour; seen 1.26e-4); the fp32 recon portion off it by more than
5e-4 (seen 1.7e-3), so that the rounding shows.
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

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

RECON = dict(lpips_weight=0.0)


def _named(tree) -> dict:
    """A JAX params-shaped tree of numpy arrays -> the port's names."""
    return {f"{tower}.{k}": v for tower, sd in from_jax.swap_from_jax(tree).items()
            for k, v in sd.items()}


def _rel(a: dict, b: dict) -> float:
    num = sum(float((a[k] - b[k]).double().pow(2).sum()) for k in b)
    return (num / sum(float(v.double().pow(2).sum()) for v in b.values())) ** 0.5


def test_bf16_accumulator_matches_jax_split_step():
    jcfg, jparams, batch, key = full_loss_setup()
    jparams = {k: v for k, v in jparams.items() if k not in ("landmark_head", "lpips")}
    _, j_loss_fn, _ = JT.make_train_step(jcfg, JT.TrainConfig(),
                                         recon=ReconLossConfig(**RECON_KW, **RECON))
    (j_loss_r, _), gr = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True),
                                static_argnames="portion")(jparams, batch, key,
                                                           portion="recon")
    labels = JT.trainable_labels(gr)
    gr = jax.tree.map(lambda g, l: np.asarray(g.astype(jnp.bfloat16), np.float32)
                      if l == "train" else np.zeros(g.shape, np.float32), gr, labels)
    j_recon = _named(gr)
    train = [k for k, l in PT.trainable_labels(j_recon).items() if l == "train"]
    want = {k: j_recon[k] for k in train}

    params = from_jax.swap_from_jax(jparams)
    draws = jax_draws(key, 2, 8, JT.TrainConfig())
    recon = {}
    for acc in ("bfloat16", "float32"):
        step, _, state = port_full_step(
            params, PT.TrainConfig(split_grad=1, split_acc_dtype=acc), **RECON)
        loss_r, _ = step.recon_backward(state.modules, batch, draws)
        assert abs(loss_r.item() / float(j_loss_r) - 1) < 1e-5
        named = PT.named_params(state.modules)
        recon[acc] = {k: named[k].grad if named[k].grad is not None
                      else torch.zeros_like(named[k]) for k in train}
    assert _rel(recon["bfloat16"], want) <= 5e-4
    assert _rel(recon["float32"], want) > 5e-4
