"""The port's slice end to end: reface_tpu_torch FaceSwapper.swap against the
JAX package's FaceSwapper.swap on tiny_swap_config(64, 2), fp32, CPU; and
the DDIM sampler alone against the JAX one on a toy model.

Both run the same pre-cropped batch with the same weights (random numpy
leaves carried JAX -> port through reface_tpu_torch.ckpt.from_jax), a fixed
numpy x_T, sample_posterior=False, landmarks given and the CFG prefix dedup
on, so no random draw is left on either side (eta = 0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import nchw, nhwc, random_tree
from test_torch_port_helpers import one_torch_thread

from reface_tpu.core.schedules import DDIMTables as JTables
from reface_tpu.core.schedules import DiffusionSchedule as JSchedule
from reface_tpu.diffusion.ddim import ddim_sample as j_ddim
from reface_tpu.pipelines.swap import FaceSwapper as JSwapper
from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.core.schedules import DDIMTables as PTables
from reface_tpu_torch.core.schedules import DiffusionSchedule as PSchedule
from reface_tpu_torch.diffusion.ddim import ddim_sample as p_ddim
from reface_tpu_torch.pipelines.swap import FaceSwapper as PSwapper
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _inputs(b=2, size=64, seed=0):
    rng = np.random.default_rng(seed)
    target = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    mask = np.ones((b, size, size, 1), np.float32)
    mask[:, size // 4: 3 * size // 4, size // 4: 3 * size // 4] = 0.0
    return dict(
        target_image=target,
        inpaint_image=target * mask,
        inpaint_mask=mask,
        ref_clip224=rng.normal(size=(b, 224, 224, 3)).astype(np.float32),
        landmarks=rng.uniform(0, size, (b, 136)).astype(np.float32),
        x_T=rng.normal(size=(b, size // 8, size // 8, 4)).astype(np.float32),
    )


def test_swap_matches_jax():
    """2 DDIM steps with CFG 3 and dedup. 1e-4 on the [-1,1] images: fp32
    both sides, only summation order differs (6e-6 seen; the margin is for
    other BLAS builds and thread counts)."""
    jcfg = dataclasses.replace(j_tiny(64, 2), sample_posterior=False)
    pcfg = dataclasses.replace(p_tiny(64, 2), sample_posterior=False)
    assert jcfg.cfg_dedup and pcfg.cfg_dedup and pcfg.cfg_scale == 3.0
    shapes = jax.eval_shape(lambda k: JSwapper.init_params(jcfg, k),
                            jax.random.key(0))
    params = {name: random_tree(tree, seed=i)
              for i, (name, tree) in enumerate(shapes.items())}
    inputs = _inputs()

    ref = np.asarray(JSwapper(jcfg, params).swap(**inputs))
    port = PSwapper(pcfg, device="cpu", params={
        "unet": from_jax.unet_from_jax(params["unet"]),
        "vae": from_jax.vae_from_jax(params["vae"]),
        "conditioner": from_jax.conditioner_from_jax(params["conditioner"]),
    })
    got = port.swap(**inputs)

    assert isinstance(got, torch.Tensor) and got.shape == (2, 64, 64, 3)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    inside = np.abs(ref) < 0.99
    assert inside.mean() > 0.5  # not saturated by the clamp: a real check
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


# ---------------------------------------------------------------- sampler

_W = np.random.default_rng(9).normal(size=(9, 4)).astype(np.float32) / 3


def _j_model(x9, t, ctx):
    """A toy eps model (NHWC) that reads x9, t and the context."""
    c = (t / 1000.0)[:, None, None, None] * ctx.mean(axis=(1, 2))[:, None, None, None]
    return jnp.tanh(x9 @ _W + c)


def _p_model(x9, t, ctx):
    c = (t / 1000.0)[:, None, None, None] * ctx.mean(dim=(1, 2))[:, None, None, None]
    return torch.tanh(torch.einsum("bchw,ck->bkhw", x9, torch.from_numpy(_W)) + c)


def _dedup(model):
    cat = (lambda a: jnp.concatenate([a, a])) if model is _j_model else \
        (lambda a: torch.cat([a, a]))
    return lambda x9, t, ctx2: model(cat(x9), cat(t), ctx2)


@pytest.mark.parametrize("cfg_steps,dedup", [(None, False), (None, True), (3, True)])
def test_ddim_sample_matches_jax(cfg_steps, dedup):
    """The 50-step scan as a Python loop: CFG 3 (uncond first), the dedup
    path and the cfg_steps interval, on a toy model. fp32; the latents grow
    to ~45 over the 6 steps, so 1e-5 absolute plus 1e-5 relative."""
    rng = np.random.default_rng(4)
    b, hw = 2, 4
    x_T, z = (rng.normal(size=(b, hw, hw, 4)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(b, hw, hw, 1)) > 0.5).astype(np.float32)
    c, uc = (rng.normal(size=(b, 1, 8)).astype(np.float32) for _ in range(2))
    jt = JTables.create(JSchedule.create(), 6)
    pt = PTables.create(PSchedule.create(), 6)
    ref = j_ddim(_j_model, *map(jnp.asarray, (x_T, c, uc, z, mask)), jt, 3.0,
                 cfg_steps=cfg_steps, dedup_model_fn=_dedup(_j_model) if dedup else None)
    got = p_ddim(_p_model, nchw(x_T), torch.from_numpy(c), torch.from_numpy(uc),
                 nchw(z), nchw(mask), pt, 3.0, cfg_steps=cfg_steps,
                 dedup_model_fn=_dedup(_p_model) if dedup else None)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_ddim_eta_draws_from_the_generator():
    """eta > 0 takes its noise from the given torch.Generator: the same seed
    gives the same chain, another seed or eta = 0 another one."""
    rng = np.random.default_rng(5)
    x_T, z = (nchw(rng.normal(size=(1, 4, 4, 4))) for _ in range(2))
    mask = torch.ones(1, 1, 4, 4)
    c, uc = (torch.from_numpy(rng.normal(size=(1, 1, 8)).astype(np.float32))
             for _ in range(2))
    tables = PTables.create(PSchedule.create(), 4, eta=0.5)
    run = lambda eta, seed: p_ddim(
        _p_model, x_T, c, uc, z, mask, tables, 3.0, eta=eta,
        generator=None if seed is None else torch.Generator().manual_seed(seed))
    a, b2, other = run(0.5, 0), run(0.5, 0), run(0.5, 1)
    assert torch.equal(a, b2) and torch.isfinite(a).all()
    assert not torch.allclose(a, other)
    assert not torch.allclose(a, run(0.0, None))
    with pytest.raises(ValueError):
        run(0.5, None)
