"""The port's pools and resizes that sit under autograd, as products with
constant matrices (reface_tpu_torch/ops/separable.py): values and VJPs
against the JAX functions, and against the torch ops they replace, on the
CPU.

- adaptive_avg_pool2d against reface_tpu/ops/pooling.py;
- resize_bilinear_aa against jax.image.resize(..., "bilinear");
- resize_bilinear_align_corners against reface_tpu/nn/bisenet.py's.

The shapes are the guided path's scaled down (ID: 512 -> 256, the 188 px
crop -> 112; exp: 512 -> 224; seg: 512 -> 256 and BiSeNet's 32 -> 256
logits) and ratios that do not divide. Tolerance: 1e-5 of the largest
magnitude of the reference (values and VJPs), fp32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_port_helpers import nchw, nhwc
from test_torch_port_helpers import one_torch_thread

from reface_tpu.nn.bisenet import resize_bilinear_align_corners as j_align
from reface_tpu.ops.pooling import adaptive_avg_pool2d as j_pool
from reface_tpu_torch.nn.bisenet import resize_bilinear_align_corners as p_align
from reface_tpu_torch.ops.pooling import adaptive_avg_pool2d as p_pool
from reface_tpu_torch.ops.resize import resize_bilinear_aa as p_aa
from reface_tpu_torch.ops.separable import ieee_fp32_products

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

REL = 1e-5


def j_aa(x, h, w):
    return jax.image.resize(x, (x.shape[0], h, w, x.shape[3]), "bilinear")


def close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * np.abs(ref).max())


def value_and_vjp(j_fn, p_fn, shape, out, seed):
    """Both packages' f(x) and the VJP of a random cotangent, NHWC numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=(shape[0], *out, shape[3])).astype(np.float32)
    ref, pull = jax.vjp(lambda a: j_fn(a, *out), jnp.asarray(x))
    (ref_dx,) = pull(jnp.asarray(g))
    xx = nchw(x).requires_grad_(True)
    y = p_fn(xx, *out)
    (dx,) = torch.autograd.grad(y, xx, nchw(g))
    return (nhwc(y.detach()), np.asarray(ref)), (nhwc(dx), np.asarray(ref_dx))


@pytest.mark.parametrize("shape,out", [((2, 64, 64, 3), (32, 32)),
                                       ((2, 47, 47, 3), (28, 28)),
                                       ((1, 30, 45, 2), (20, 33))])
def test_pool_value_and_vjp_match_jax(shape, out):
    for got, ref in value_and_vjp(j_pool, p_pool, shape, out, 1):
        close(got, ref)


@pytest.mark.parametrize("shape,out", [((2, 64, 64, 3), (28, 28)),
                                       ((1, 45, 50, 2), (20, 33)),
                                       ((1, 16, 12, 3), (40, 27))])
def test_resize_aa_value_and_vjp_match_jax(shape, out):
    for got, ref in value_and_vjp(j_aa, p_aa, shape, out, 2):
        close(got, ref)


@pytest.mark.parametrize("shape,out", [((2, 8, 8, 19), (64, 64)),
                                       ((1, 7, 9, 3), (20, 31))])
def test_align_corners_value_and_vjp_match_jax(shape, out):
    for got, ref in value_and_vjp(j_align, p_align, shape, out, 3):
        close(got, ref)


TORCH_OPS = {
    "pool": (p_pool, lambda x, h, w: F.adaptive_avg_pool2d(x, (h, w)), (33, 40), (20, 16)),
    "aa": (p_aa, lambda x, h, w: F.interpolate(x, size=(h, w), mode="bilinear",
                                               align_corners=False, antialias=True),
           (48, 40), (20, 33)),
    "align_corners": (p_align, lambda x, h, w: F.interpolate(x, size=(h, w), mode="bilinear",
                                                             align_corners=True),
                      (9, 7), (40, 31)),
}


@pytest.mark.parametrize("name", sorted(TORCH_OPS))
def test_matches_the_torch_op_it_replaces(name):
    """The matrix form against F.adaptive_avg_pool2d / F.interpolate on the
    CPU: the same function, values and input gradients. The port runs
    under a caller's TF32 setting, which its products turn off for
    themselves and give back."""
    port, op, hw, out = TORCH_OPS[name]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 3, *hw)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 3, *out)).astype(np.float32))
    res = []
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with ieee_fp32_products():
            assert torch.get_float32_matmul_precision() == "highest"
        for fn in (port, op):
            xx = x.clone().requires_grad_(True)
            y = fn(xx, *out)
            res.append((y.detach().numpy(), torch.autograd.grad(y, xx, g)[0].numpy()))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
    for got, ref in zip(*res):
        close(got, ref)
