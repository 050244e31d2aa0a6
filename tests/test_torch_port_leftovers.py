"""The JAX package's small public names that the port adds: the `decow` TPS
mask warp (random_tps_mask_warp), the img2img encode (stochastic_encode)
and the Gaussian KL (normal_kl), each against the JAX function on the
JAX key's draws, on the CPU.

Tolerances: fp32 on both sides; the warp within 1e-5 at the default 3 x 3
grid (a 9-point TPS solve and a bilinear sample of a mask in [0, 1]) and
5e-5 at a 5 x 5 grid, where the 25-point fp32 solve puts each package
~1e-5 from float64 (test_torch_port_priors.py holds the TPS so); the
encode and the KL within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import nchw, nhwc
from test_torch_port_helpers import one_torch_thread

from reface_tpu.core.distributions import normal_kl as j_normal_kl
from reface_tpu.core.schedules import DDIMTables as JTables, DiffusionSchedule as JSchedule
from reface_tpu.diffusion.ddim import stochastic_encode as j_stochastic_encode
from reface_tpu.preprocess.tps import random_tps_mask_warp as j_warp
from reface_tpu_torch.core import normal_kl
from reface_tpu_torch.core.schedules import DDIMTables, DiffusionSchedule
from reface_tpu_torch.diffusion.ddim import stochastic_encode
from reface_tpu_torch.preprocess import random_tps_mask_warp, tps_mask_warp

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def j_warp_draws(key, scale_range, grid_n):
    """The scale and noise random_tps_mask_warp draws from `key`."""
    k_scale, k_noise = jax.random.split(key)
    scale = jax.random.uniform(k_scale, (), minval=scale_range[0], maxval=scale_range[1])
    noise = jax.random.uniform(k_noise, (grid_n - 2, grid_n - 2, 2))
    return float(scale), torch.from_numpy(np.array(noise))


def mask(b, h, w, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((b, h, w, 1), np.float32)
    m[:, h // 4: 3 * h // 4, w // 5: 4 * w // 5] = 1.0
    return np.clip(m + rng.uniform(0, 0.3, size=m.shape).astype(np.float32), 0, 1)


@pytest.mark.parametrize("scale_range,grid_n,hw,tol", [((0.5, 1.0), 3, (32, 32), 1e-5),
                                                        ((0.2, 0.6), 5, (24, 40), 5e-5)])
def test_tps_mask_warp_matches_jax_on_its_draws(scale_range, grid_n, hw, tol):
    m = mask(2, *hw, 0)
    key = jax.random.key(7)
    ref = j_warp(key, jnp.asarray(m), scale_range=scale_range, grid_n=grid_n)
    scale, noise = j_warp_draws(key, scale_range, grid_n)
    got = tps_mask_warp(nchw(m), scale, noise)
    assert got.shape == (2, 1, *hw)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=tol, rtol=0)
    assert not np.allclose(nhwc(got), m, atol=1e-3)


def test_random_tps_mask_warp_draws_from_its_generator():
    m = nchw(mask(2, 32, 32, 1))
    a = random_tps_mask_warp(m, torch.Generator().manual_seed(3))
    b = random_tps_mask_warp(m, torch.Generator().manual_seed(3))
    c = random_tps_mask_warp(m, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == m.shape and float(a.min()) >= 0.0 and float(a.max()) <= 1.0 + 1e-6
    # the same warp for every sample of the batch, as the JAX function's
    one = random_tps_mask_warp(m[:1], torch.Generator().manual_seed(3))
    np.testing.assert_allclose(a[:1].numpy(), one.numpy(), atol=1e-7)


@pytest.mark.parametrize("t", [[0, 7, 19, 3], 11])
def test_stochastic_encode_matches_jax_on_its_noise(t):
    x0 = np.random.default_rng(5).normal(size=(4, 4, 8, 8)).astype(np.float32)
    key = jax.random.key(9)
    jt = JTables.create(JSchedule.create(), 20)
    ref = j_stochastic_encode(jnp.asarray(x0), jnp.asarray(t), jt, key)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, x0.shape, jnp.float32)))
    tt = DDIMTables.create(DiffusionSchedule.create(), 20)
    got = stochastic_encode(torch.from_numpy(x0), t, tt, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    drawn = stochastic_encode(torch.from_numpy(x0), t, tt, torch.Generator().manual_seed(1))
    again = stochastic_encode(torch.from_numpy(x0), t, tt, torch.Generator().manual_seed(1))
    assert torch.equal(drawn, again) and drawn.shape == x0.shape


def test_normal_kl_matches_jax():
    rng = np.random.default_rng(6)
    m1, lv1, m2, lv2 = (rng.normal(size=(3, 4, 5)).astype(np.float32) for _ in range(4))
    ref = j_normal_kl(*(jnp.asarray(a) for a in (m1, lv1, m2, lv2)))
    got = normal_kl(*(torch.from_numpy(a) for a in (m1, lv1, m2, lv2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # a scalar side broadcasts, as in the reference's prior KL against N(0, 1)
    ref0 = j_normal_kl(jnp.asarray(m1), jnp.asarray(lv1), 0.0, 0.0)
    got0 = normal_kl(torch.from_numpy(m1), torch.from_numpy(lv1), 0.0, 0.0)
    np.testing.assert_allclose(got0.numpy(), np.asarray(ref0), rtol=1e-6, atol=1e-6)
