"""The port's eps-MSE training step (reface_tpu_torch.pipelines.train and
the flash attention it differentiates) against the JAX package, on the CPU.

- The flash attention's plain forward (o, lse) and backward (dq, dk, dv)
  against the JAX package's _flash_attention, the library Pallas kernel run
  in interpret mode, under jax.vjp.
- The tiny step (tiny_swap_config(64), fp32): loss and every trainable
  gradient against jax.value_and_grad of the JAX loss_fn, with JAX's own
  draws reproduced from its split key and passed to the port; gradients are
  compared by name through reface_tpu_torch.ckpt.from_jax.
- The optimizer against optax, the EMA against reface_tpu.core.ema, the
  trainable partition, remat, resolve_train_swap_cfg and the LR schedules.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_port_helpers import j_flash_residuals as _j_flash_residuals
from test_torch_port_helpers import jax_draws as _jax_draws
from test_torch_port_helpers import random_tree
from test_torch_port_helpers import train_batch as _batch

from reface_tpu.core import ema as JE
from reface_tpu.core import lr_schedule as JL
from reface_tpu.ops.attention import _flash_attention as j_flash
from reface_tpu.pipelines import train as JT
from reface_tpu.pipelines.swap import FaceSwapper as JSwapper
from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.core import ema as PE
from reface_tpu_torch.core import lr_schedule as PL
from reface_tpu_torch.ops import attention as PA
from reface_tpu_torch.pipelines import train as PT
from reface_tpu_torch.pipelines.swap import SwapConfig
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------ flash attention

@pytest.mark.parametrize("d", [40, 80])
def test_flash_plain_matches_library(interpret_pallas, d):
    """flash_attention_fwd_plain (o, lse) and flash_attention_bwd_plain
    (dq, dk, dv) against the library kernels in interpret mode (jax.vjp of
    the JAX package's _flash_attention). fp32 both sides: 1e-5 max abs covers
    the summation orders over 256 keys and queries (the library normalises
    the output tile by tile)."""
    rng = np.random.default_rng(d)
    q, k, v, do = (rng.normal(size=(1, 2, 256, d)).astype(np.float32)
                   for _ in range(4))
    scale = d**-0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o_ref, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, scale), jq, jk, jv)
    grads_ref = vjp(jnp.asarray(do))
    o_res, lse_ref = _j_flash_residuals(jq, jk, jv, scale)
    np.testing.assert_allclose(np.asarray(o_res), np.asarray(o_ref), atol=1e-6, rtol=0)

    flat = lambda a: torch.from_numpy(a.reshape(2, 256, d))
    o, lse = PA.flash_attention_fwd_plain(flat(q), flat(k), flat(v), scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref).reshape(2, 256, d),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref).reshape(2, 256),
                               atol=1e-5, rtol=0)
    got = PA.flash_attention_bwd_plain(flat(q), flat(k), flat(v), o, lse,
                                       flat(do), scale)
    for name, g, ref in zip(("dq", "dk", "dv"), got, grads_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref).reshape(2, 256, d),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_flash_attention_function_matches_autograd():
    """FlashAttention (on the CPU: the plain versions) has the gradients of
    autograd through the plain product, and its per-kernel wrappers K4/K5
    return the same as the whole backward. Ragged N and M (not multiples of
    64), fp32: 2e-6."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(3, 200, 24)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(3, 130, 24)).astype(np.float32))
            for _ in range(2))
    do = torch.from_numpy(rng.normal(size=(3, 200, 24)).astype(np.float32))
    scale = 0.3
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = PA.FlashAttention.apply(*leaves, scale)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_out = PA.einsum_attention(*ref_leaves, scale)
    ref = torch.autograd.grad(ref_out, ref_leaves, do)
    torch.testing.assert_close(out, ref_out, atol=2e-6, rtol=0)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=2e-6, rtol=0)
    o, lse = PA.flash_attention_fwd(q, k, v, scale)
    di = PA.row_dot(o, do)
    dk, dv = PA.flash_bwd_dkv(q, k, v, lse, do, di, scale)
    dq = PA.flash_bwd_dq(q, k, v, lse, do, di, scale)
    for a, b in zip((dq, dk, dv), PA.flash_attention_bwd(q, k, v, o, lse, do, scale)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ------------------------------------------------------------ the tiny step

@pytest.fixture(scope="module")
def tiny():
    """Random JAX params of tiny_swap_config(64), a batch, and a key whose
    CFG dropout draws both a dropped and a kept sample."""
    jcfg = j_tiny(image_size=64)
    shapes = jax.eval_shape(lambda k: JSwapper.init_params(jcfg, k),
                            jax.random.key(0))
    params = {name: random_tree(tree, seed=i)
              for i, (name, tree) in enumerate(shapes.items())}
    tcfg = JT.TrainConfig()
    key = next(jax.random.key(s) for s in range(100)
               if len(set(_jax_draws(jax.random.key(s), 2, 8, tcfg)["drop"])) == 2)
    return jcfg, params, _batch(), key


def _port_grads(params, batch, draws, train_cfg=PT.TrainConfig()):
    _, loss_fn, init_state = PT.make_train_step(p_tiny(image_size=64), train_cfg,
                                                device="cpu")
    state = init_state(params)
    loss, _ = loss_fn(state.modules, batch, draws)
    loss.backward()
    return loss, PT.named_params(state.modules)


@pytest.fixture(scope="module")
def port_grads(tiny):
    """The port's loss and gradients of the tiny step under the default
    TrainConfig (UNet remat on), from the JAX draws of `tiny`'s key: read
    by the JAX comparison and the remat check, computed once."""
    _, params, batch, key = tiny
    draws = _jax_draws(key, 2, 8, JT.TrainConfig())
    return _port_grads(from_jax.swap_from_jax(params), batch, draws)


def test_eps_step_matches_jax(tiny, port_grads):
    """Loss within 1e-5 relative and each trainable gradient within 1e-4
    relative L2 of jax.value_and_grad of the JAX loss_fn (fp32 both sides;
    conv and matmul summation orders differ, and the gradients pass through
    the whole UNet). Relative to the larger of the leaf's norm and 1e-3 of
    the whole gradient's: in the tiny UNet a GroupNorm of one channel per
    group cancels the bias before it, so some leaves are zero in exact
    arithmetic and carry only ~1e-8 of rounding on either side. Leaves the
    step does not use (the single-token cross-attention's to_q/to_k and
    norm2) have no gradient in the port and a zero one in JAX. Frozen towers
    get no gradient on either side."""
    jcfg, params, batch, key = tiny
    _, j_loss_fn, _ = JT.make_train_step(jcfg, JT.TrainConfig())
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True))(
        params, batch, key)
    loss, named = port_grads
    assert abs(loss.item() / float(j_loss) - 1) < 1e-5

    ref = {f"{tower}.{k}": v.numpy() for tower, sd in
           from_jax.swap_from_jax(jax.tree.map(np.asarray, j_grads)).items()
           for k, v in sd.items()}
    labels = PT.trainable_labels(named)
    assert {"train", "freeze"} == set(labels.values())
    total = np.sqrt(sum(np.sum(ref[n].astype(np.float64) ** 2)
                        for n in named if labels[n] == "train"))
    unused = 0
    for name, p in named.items():
        if labels[name] == "freeze":
            assert p.grad is None and not p.requires_grad, name
            assert not np.any(ref[name]), name  # JAX's stop_gradient
        elif p.grad is None:
            assert not np.any(ref[name]), name
            unused += 1
        else:
            diff = np.linalg.norm(p.grad.numpy().astype(np.float64) - ref[name])
            assert diff <= 1e-4 * max(np.linalg.norm(ref[name]), 1e-3 * total), name
    assert unused < 0.1 * len(named)


def test_remat_keeps_the_gradients(tiny, port_grads):
    """The UNet's torch.utils.checkpoint remat recomputes the same values:
    the gradients with and without it agree (2e-6 relative L2; fp32 on the
    CPU recomputes the same products)."""
    _, params, batch, key = tiny
    draws = _jax_draws(key, 2, 8, JT.TrainConfig())
    loss_r, with_remat = port_grads
    loss_n, without = _port_grads(from_jax.swap_from_jax(params), batch, draws,
                                  PT.TrainConfig(force_unet_remat=False))
    assert loss_r.item() == loss_n.item()
    for name, a in with_remat.items():
        if a.grad is not None:
            assert _rel(a.grad.numpy(), without[name].grad.numpy()) <= 2e-6, name


def test_train_step_updates_only_trainables(tiny):
    """Two steps from a torch.Generator: the loss is finite, the UNet and the
    conditioner heads move, the frozen towers stay bit-identical, and the
    EMA shadow follows the UNet."""
    _, params, batch, _ = tiny
    step, _, init_state = PT.make_train_step(
        p_tiny(image_size=64), PT.TrainConfig(warmup_steps=1, ema_decay=0.9),
        device="cpu")
    state = init_state(from_jax.swap_from_jax(params))
    before = {k: p.detach().clone() for k, p in PT.named_params(state.modules).items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, metrics = step(state, batch, generator=gen)
        assert torch.isfinite(metrics["loss"])
    labels = PT.trainable_labels(before)
    after = PT.named_params(state.modules)
    assert state.step == 2 and state.opt.count == 2 and state.ema.updates == 2
    for name, old in before.items():
        moved = not torch.equal(after[name], old)
        if labels[name] == "freeze":
            assert not moved, name
        elif after[name].grad is not None and after[name].grad.any():
            assert moved, name  # the rest move only by weight decay
    shadow = PT.params_with_ema(state.params(), state)["unet"]
    assert shadow.keys() == state.modules.unet.state_dict().keys()
    assert any(not torch.equal(shadow[k], v)
               for k, v in state.modules.unet.state_dict().items())


def test_trainable_labels_match_jax(tiny):
    """The port's partition over its names is the JAX package's over flax
    paths, leaf by leaf through the converters."""
    _, params, _, _ = tiny
    labels = JT.trainable_labels(params)
    as_arrays = jax.tree.map(
        lambda p, lab: np.full(np.shape(p), lab == "train", np.float32),
        params, labels)
    ref = {f"{tower}.{k}": v.numpy() for tower, sd in from_jax.swap_from_jax(as_arrays).items()
           for k, v in sd.items()}
    names = {f"{tower}.{k}" for tower, sd in from_jax.swap_from_jax(params).items() for k in sd
             if not k.endswith("num_batches_tracked")}
    got = PT.trainable_labels(names)
    for name in names:
        want = "train" if ref[name].all() else "freeze"
        assert ref[name].all() or not ref[name].any(), name
        assert got[name] == want, name
    assert got["conditioner.cond_stage_model.mapper2.resblocks.0.attn.c_qkv.weight"] == "train"
    assert got["conditioner.cond_stage_model.model.visual_projection.weight"] == "freeze"


def test_resolve_train_swap_cfg():
    """The semantics of tests/test_train.py::test_resolve_train_swap_cfg_
    forces_remat: flash attention and UNet remat for training, VAE remat
    only with the recon loss, and force_unet_remat=False honoured."""
    base = SwapConfig()
    assert not base.unet.remat
    r = PT.resolve_train_swap_cfg(base, PT.TrainConfig(), object())
    assert r.unet.remat and r.vae.remat and r.unet.attn_impl == "flash"
    r = PT.resolve_train_swap_cfg(base, PT.TrainConfig(), None)
    assert r.unet.remat and not r.vae.remat
    r = PT.resolve_train_swap_cfg(base, PT.TrainConfig(force_unet_remat=False), None)
    assert not r.unet.remat
    # the full loss and split_grad build (what raised before they were
    # ported); only a split the step does not know is refused
    for kw in (dict(), dict(split_grad=1), dict(split_grad=2)):
        step, _, _ = PT.make_train_step(p_tiny(64), PT.TrainConfig(**kw),
                                        recon=PT.ReconLossConfig(), device="cpu")
        assert callable(step.loss_and_grads)
    with pytest.raises(ValueError, match="split_grad"):
        PT.make_train_step(base, PT.TrainConfig(split_grad=3), device="cpu")


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


def test_param_dtype_keeps_fp32_masters():
    """The trainer's towers keep fp32 weights where they are trained and
    compute in the config's dtype; serving stores the compute dtype. A bf16
    update far below bf16's resolution still moves an fp32 master."""
    from reface_tpu_torch.nn.layers import Linear

    lin = Linear(8, 4, dtype=torch.bfloat16, param_dtype=torch.float32)
    assert lin.weight.dtype == torch.float32 and lin.bias.dtype == torch.float32
    y = lin(torch.ones(2, 8))
    assert y.dtype == torch.bfloat16
    ref = torch.nn.functional.linear(torch.ones(2, 8, dtype=torch.bfloat16),
                                     lin.weight.bfloat16(), lin.bias.bfloat16())
    torch.testing.assert_close(y, ref, atol=0, rtol=0)
    with torch.no_grad():
        w = lin.weight.clone()
        lin.weight.add_(1e-6 * w.abs().max())
    assert not torch.equal(lin.weight, w)
    assert Linear(8, 4, dtype=torch.bfloat16).weight.dtype == torch.bfloat16
    cfg = dataclasses.replace(p_tiny(64), unet=dataclasses.replace(
        p_tiny(64).unet, dtype=torch.bfloat16))
    _, _, init_state = PT.make_train_step(cfg, PT.TrainConfig(), device="cpu")
    state = init_state()
    assert {p.dtype for p in state.opt.params} == {torch.float32}
    assert state.modules.unet.input_blocks[0][0].compute_dtype == torch.bfloat16
