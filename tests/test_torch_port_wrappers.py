"""K3's plain version (group_norm_silu_plain) against the JAX group_norm_silu,
and the kernel wrappers' refusals: on a tensor that is neither on the CPU
nor on the card they raise, and they never cut a gradient.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import nchw, nhwc
from test_torch_port_helpers import one_torch_thread

from reface_tpu.ops.groupnorm import group_norm_silu as j_gn
from reface_tpu_torch.ops import attention as PA
from reface_tpu_torch.ops.attention_smalld import self_attention_smalld
from reface_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def test_kernel_wrappers_refuse_what_they_cannot_take():
    """On a non-CPU, non-CUDA tensor the wrappers raise; they never fall back."""
    q = torch.zeros(2, 512, 40, device="meta")
    with pytest.raises(ValueError):
        self_attention_smalld(q, q, q)
    with pytest.raises(ValueError):
        PA.wide_attention(q, q, q)
    with pytest.raises(ValueError):
        group_norm_silu(torch.zeros(1, 32, 8, 8, device="meta"),
                        torch.ones(32), torch.zeros(32))


def test_kernel_wrappers_refuse_to_cut_gradients():
    """K1/K2/K3 have no backward: on a non-CPU tensor that requires grad
    each wrapper raises (naming the differentiable route) instead of
    returning a detached output; under no_grad it goes on to its checks."""
    q = torch.zeros(2, 512, 40, device="meta", requires_grad=True)
    x = torch.zeros(1, 32, 8, 8, device="meta", requires_grad=True)
    calls = [lambda: self_attention_smalld(q, q, q),
             lambda: PA.wide_attention(q, q, q),
             lambda: group_norm_silu(x, torch.ones(32), torch.zeros(32))]
    for call, route in zip(calls, ("flash", "flash", "fused_groupnorm=False")):
        with pytest.raises(RuntimeError, match=route):
            call()
        with torch.no_grad(), pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("shape,groups,eps,silu", [
    ((2, 8, 8, 64), 32, 1e-5, True),
    ((1, 16, 16, 96), 32, 1e-6, False),
    ((3, 4, 4, 12), 4, 1e-5, True),
])
def test_groupnorm_plain_matches_jax(shape, groups, eps, silu):
    """K3's plain version vs group_norm_silu (the JAX _reference_impl off-TPU),
    NHWC there and NCHW here; 1e-5 covers fp32 reduction order."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    scale = rng.normal(size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    ref = j_gn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
               groups=groups, eps=eps, silu=silu)
    args = (torch.from_numpy(scale), torch.from_numpy(bias), groups, eps, silu)
    got = group_norm_silu(nchw(x), *args)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.numpy(), group_norm_silu_plain(nchw(x), *args).numpy())
