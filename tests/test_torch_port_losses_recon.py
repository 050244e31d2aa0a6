"""The pieces of the port's recon loss (reface_tpu_torch.diffusion.losses)
against the JAX package's, on the CPU, fp32, inputs from numpy seeds: the
reconstruction's timestep sequence, the average pooling to LPIPS scales,
the keep mask's upsampling and the ID cosine loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import assert_close, nchw, nhwc, one_torch_thread

from reface_tpu.diffusion import losses as JLoss
from reface_tpu_torch.diffusion import losses as PLoss

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

# ------------------------------------------------------------------ modules


# ------------------------------------------------------------------ pieces

@pytest.mark.parametrize("t_new,k", [(999, 4), (999, 2), (999, 50), (10, 4), (3, 4)])
def test_recon_timestep_seq_matches_jax(t_new, k):
    assert PLoss.recon_timestep_seq(t_new, k) == JLoss.recon_timestep_seq(t_new, k)
    if (t_new, k) == (999, 4):
        assert PLoss.recon_timestep_seq(t_new, k) == [748, 499, 250, 1]


@pytest.mark.parametrize("size", [64, 32, 16])
def test_avg_pool_to_matches_jax(size):
    x = np.random.default_rng(6).normal(size=(2, 64, 64, 3)).astype(np.float32)
    got = PLoss.avg_pool_to(nchw(x), size)
    assert_close(nhwc(got), JLoss.avg_pool_to(jnp.asarray(x), size), atol=1e-6)


@pytest.mark.parametrize("hw,size", [(8, 64), (32, 256)])
def test_keep_mask_upsampling_matches_jax_resize(hw, size):
    """The ID mask: jax.image.resize(..., "bilinear") upsamples with
    half-pixel centres, F.interpolate(align_corners=False) (1e-6)."""
    m = (np.random.default_rng(7).uniform(size=(2, hw, hw, 1)) > 0.5).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(m), (2, size, size, 1), "bilinear")
    assert_close(nhwc(PLoss.upsample_keep_mask(nchw(m), size)), ref, atol=1e-6)


def test_id_cosine_loss_matches_jax():
    rng = np.random.default_rng(8)
    w = rng.normal(size=(12, 5)).astype(np.float32)
    a, b = (rng.normal(size=(3, 2, 2, 3)).astype(np.float32) for _ in range(2))

    def j_embed(x):
        f = x.reshape(x.shape[0], -1) @ w
        return f / jnp.linalg.norm(f, axis=-1, keepdims=True)

    def p_embed(x):
        f = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1) @ torch.from_numpy(w)
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    ref = JLoss.id_cosine_loss(j_embed, jnp.asarray(a), jnp.asarray(b))
    a_t = nchw(a).requires_grad_()
    got = PLoss.id_cosine_loss(p_embed, a_t, nchw(b).requires_grad_())
    assert_close(got, ref, atol=1e-6)
    got.backward()
    g_ref = jax.grad(lambda x: JLoss.id_cosine_loss(j_embed, x, jnp.asarray(b)))(jnp.asarray(a))
    assert_close(nhwc(a_t.grad), g_ref, atol=1e-6)


# ------------------------------------------------------------ the full loss


# ------------------------------------------------------- flash plain, D = 512
