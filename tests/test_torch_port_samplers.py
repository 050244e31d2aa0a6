"""The port's other samplers and the tiles against the JAX package, fp32, CPU.

PLMS and DPM-Solver++(2M) run on the toy eps model of
test_torch_port_swap.py (it reads x9, t and the context), with the same
numpy inputs on both sides; the lam_uniform grid, the fold/unfold tiling
and the distilled-student rung (DDIM-10 at cfg_scale 1.0) likewise. The
samplers' latents grow to tens over the steps: 1e-5 absolute plus 1e-5
relative, as the DDIM case has (fp32 both sides, summation order only).
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import nchw, nhwc
from test_torch_port_swap import _dedup, _j_model, _p_model

from reface_tpu.core.schedules import DDIMTables as JTables
from reface_tpu.core.schedules import DiffusionSchedule as JSchedule
from reface_tpu.core.schedules import make_ddim_timesteps as j_timesteps
from reface_tpu.diffusion.ddim import ddim_sample as j_ddim
from reface_tpu.diffusion.dpm_solver import dpm_solver_sample as j_dpm
from reface_tpu.diffusion.plms import plms_sample as j_plms
from reface_tpu.parallel import tiling as JT
from reface_tpu_torch.core.schedules import DDIMTables as PTables
from reface_tpu_torch.core.schedules import DiffusionSchedule as PSchedule
from reface_tpu_torch.core.schedules import make_ddim_timesteps as p_timesteps
from reface_tpu_torch.diffusion.ddim import ddim_sample as p_ddim
from reface_tpu_torch.diffusion.dpm_solver import dpm_solver_sample as p_dpm
from reface_tpu_torch.diffusion.plms import plms_sample as p_plms
from reface_tpu_torch.parallel import tiling as PT
from reface_tpu_torch.pipelines.swap import FaceSwapper, tiny_swap_config

TOL = dict(atol=1e-5, rtol=1e-5)


def _chain_inputs(seed, b=2, hw=4):
    """(x_T, c, uc, z_inpaint, mask) as numpy, NHWC latents."""
    rng = np.random.default_rng(seed)
    x_T, z = (rng.normal(size=(b, hw, hw, 4)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(b, hw, hw, 1)) > 0.5).astype(np.float32)
    c, uc = (rng.normal(size=(b, 1, 8)).astype(np.float32) for _ in range(2))
    return x_T, c, uc, z, mask


def _both(inputs):
    """The inputs for the JAX sampler and for the port's, in that order."""
    x_T, c, uc, z, mask = inputs
    return (tuple(map(jnp.asarray, (x_T, c, uc, z, mask))),
            (nchw(x_T), torch.from_numpy(c), torch.from_numpy(uc), nchw(z), nchw(mask)))


def _tables(steps, method="uniform"):
    return (JTables.create(JSchedule.create(), steps, method=method),
            PTables.create(PSchedule.create(), steps, method=method))


def test_plms_matches_jax():
    """PLMS over DDIMTables(6) (7 steps: 1000 // 6 does not divide 1000):
    the improved-Euler step 0 (two evaluations), the Adams-Bashforth steps
    of orders 2, 3 and 4, CFG 3 batch-doubled."""
    calls = []
    counted = lambda x9, t, ctx: (calls.append(x9.shape[0]), _p_model(x9, t, ctx))[1]
    (jx, jc, juc, jz, jm), (px, pc, puc, pz, pm) = _both(_chain_inputs(6))
    jt, pt = _tables(6)
    ref = j_plms(_j_model, jx, jc, juc, jz, jm, jt, 3.0)
    got = p_plms(counted, px, pc, puc, pz, pm, pt, 3.0)
    assert calls == [4] * (pt.num_steps + 1)  # each evaluation of the CFG pair
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)
    # without CFG the model sees the conditional context alone
    ref1 = j_plms(_j_model, jx, jc, None, jz, jm, jt, 3.0)
    got1 = p_plms(_p_model, px, pc, None, pz, pm, pt, 3.0)
    np.testing.assert_allclose(nhwc(got1), np.asarray(ref1), **TOL)


@pytest.mark.parametrize("method", ["uniform", "lam_uniform"])
def test_dpm_solver_matches_jax(method):
    """DPM-Solver++(2M) over 6 steps, CFG 3, on each grid, at every
    combination of cfg_steps None/3, the prefix dedup on/off and
    lower_order_final auto (on, at 6 < 15 steps)/off."""
    (jx, jc, juc, jz, jm), (px, pc, puc, pz, pm) = _both(_chain_inputs(7))
    jt, pt = _tables(6, method)
    for cfg_steps, dedup, lof in itertools.product((None, 3), (False, True), (None, False)):
        ref = j_dpm(_j_model, jx, jc, juc, jz, jm, jt, 3.0, cfg_steps=cfg_steps,
                    dedup_model_fn=_dedup(_j_model) if dedup else None,
                    lower_order_final=lof)
        got = p_dpm(_p_model, px, pc, puc, pz, pm, pt, 3.0, cfg_steps=cfg_steps,
                    dedup_model_fn=_dedup(_p_model) if dedup else None,
                    lower_order_final=lof)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL,
                                   err_msg=f"cfg_steps={cfg_steps} dedup={dedup} lof={lof}")


def test_lam_uniform_grid_matches_jax():
    """The logSNR-uniform subset equals the JAX one at S = 10, 20 and 50
    (exactly S distinct steps), and the tables carry it; too many steps and
    a missing alphas_cumprod raise ValueError."""
    acp = PSchedule.create().alphas_cumprod.numpy().astype(np.float64)
    for s in (10, 20, 50):
        ref = j_timesteps(s, 1000, "lam_uniform", alphas_cumprod=acp)
        got = p_timesteps(s, 1000, "lam_uniform", alphas_cumprod=acp)
        np.testing.assert_array_equal(got, ref)
        assert len(np.unique(got)) == s
        jt, pt = _tables(s, "lam_uniform")
        np.testing.assert_array_equal(pt.timesteps.numpy(), np.asarray(jt.timesteps))
        np.testing.assert_allclose(pt.alphas_prev.numpy(), np.asarray(jt.alphas_prev),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="num_ddim_steps <= 999"):
        p_timesteps(1000, 1000, "lam_uniform", alphas_cumprod=acp)
    with pytest.raises(ValueError, match="needs alphas_cumprod"):
        p_timesteps(10, 1000, "lam_uniform")


@pytest.mark.parametrize("scale,size,tile,stride", [
    (1, (11, 13), 6, 3),  # a UNet tile: ragged, the last start pulled in
    (1 / 8, (40, 56), 16, 8),  # a VAE encode: image pixels in, latents out
    (8, (5, 7), 4, 2),  # a VAE decode: latents in, image pixels out
])
def test_tiling_matches_jax(scale, size, tile, stride):
    """unfold (tile-major), the border weights and the weighted fold, and
    tiled_apply with a fn that changes the resolution by `scale`."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, *size, 3)).astype(np.float32)
    jt, jmeta = JT.unfold(jnp.asarray(x), tile, stride)
    pt, pmeta = PT.unfold(nchw(x), tile, stride)
    np.testing.assert_array_equal(nhwc(pt), np.asarray(jt))
    assert pt.shape[0] == 2 * len(pmeta["ys"]) * len(pmeta["xs"])
    np.testing.assert_array_equal(PT.border_weights(7), JT.border_weights(7))
    f = int(round(1 / scale)) if scale < 1 else int(scale)

    def j_fn(t):  # (N, t, t, 3) -> (N, t*scale, t*scale, 4)
        t = jnp.concatenate([t, t[..., :1] ** 2], -1)
        if scale < 1:
            return t[:, ::f, ::f]
        return jnp.repeat(jnp.repeat(t, f, 1), f, 2)

    def p_fn(t):
        t = torch.cat([t, t[:, :1] ** 2], 1)
        if scale < 1:
            return t[:, :, ::f, ::f]
        return t.repeat_interleave(f, 2).repeat_interleave(f, 3)

    ref = JT.tiled_apply(j_fn, jnp.asarray(x), tile, stride, out_channels=4, scale=scale)
    got = PT.tiled_apply(p_fn, nchw(x), tile, stride, out_channels=4, scale=scale)
    assert got.shape == (2, 4, round(size[0] * scale), round(size[1] * scale))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_student_rung_matches_jax():
    """The distilled-student serving rung, SwapConfig(ddim_steps=10,
    cfg_scale=1.0): one conditional evaluation a step, no CFG pair."""
    calls = []
    counted = lambda x9, t, ctx: (calls.append(ctx.shape[0]), _p_model(x9, t, ctx))[1]
    (jx, jc, juc, jz, jm), (px, pc, puc, pz, pm) = _both(_chain_inputs(8))
    jt, pt = _tables(10)
    ref = j_ddim(_j_model, jx, jc, juc, jz, jm, jt, 1.0)
    got = p_ddim(counted, px, pc, puc, pz, pm, pt, 1.0,
                 dedup_model_fn=_dedup(_p_model))
    assert calls == [2] * 10
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


def test_serving_config_errors():
    """PLMS and DPM take eta = 0 only; an unknown sampler or quant mode is
    a ValueError, as is an unknown grid."""
    base = tiny_swap_config(64, 2)
    rp = dataclasses.replace
    for sampler in ("plms", "dpm"):
        with pytest.raises(ValueError, match="deterministic"):
            FaceSwapper(rp(base, sampler=sampler, eta=0.5), device="cpu")
    with pytest.raises(ValueError, match="sampler='euler'"):
        FaceSwapper(rp(base, sampler="euler"), device="cpu")
    with pytest.raises(ValueError, match="quant='int4'"):
        FaceSwapper(rp(base, unet=rp(base.unet, quant="int4")), device="cpu")
    with pytest.raises(ValueError, match="quant='fp8'"):
        FaceSwapper(rp(base, vae=rp(base.vae, quant="fp8")), device="cpu")
    with pytest.raises(ValueError, match="unknown ddim discretization"):
        FaceSwapper(rp(base, ddim_discretize="cosine"), device="cpu")
