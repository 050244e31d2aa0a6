"""K3 (GroupNorm+SiLU) on the CPU: the port's plain version against the TPU
kernel's own body, and the cut of a group into a thread-block cluster's
slices that the wrapper hands csrc/groupnorm.cu.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against group_norm_silu_plain there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_port_helpers import nchw, nhwc
from test_torch_port_helpers import one_torch_thread

from reface_tpu.ops.groupnorm import group_norm_silu as j_gn
from reface_tpu_torch.ops.groupnorm import SLICE_BYTES, cluster_plan, group_norm_silu_plain

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


@pytest.mark.parametrize("shape,silu", [((2, 8, 8, 64), True), ((1, 16, 16, 96), False)])
def test_groupnorm_plain_matches_tpu_kernel(interpret_pallas, monkeypatch, shape, silu):
    """K3's plain version vs the TPU kernel's own body
    (reface_tpu/ops/groupnorm.py:_kernel), run through its group_norm_silu
    in interpret mode with jax.default_backend saying "tpu" so that the
    VMEM guard takes the kernel (the jitted function is called unjitted, so
    no trace cached off the kernel path is reused).

    fp32 within 2e-6: the kernel's variance is the one-pass E[x^2] - mean^2
    and the plain version's the two-pass mean of squared deviations; at mean
    1 and std 3 no digit cancels, and what is left is the rounding of two
    fp32 sums over the group in different orders. bf16 within one bf16 ulp
    of each element: the same fp32 values, rounded to bf16 by both, fall on
    either side of a rounding boundary in a few elements."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    tpu_kernel = j_gn.__wrapped__
    rng = np.random.default_rng(8)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    scale = rng.normal(size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    args = (torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-5, silu)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = nchw(x).to(dt)
        xj = jnp.asarray(nhwc(xt.float())).astype(jdt)
        ref = np.asarray(tpu_kernel(xj, jnp.asarray(scale), jnp.asarray(bias),
                                    groups=32, eps=1e-5, silu=silu)).astype(np.float32)
        got = nhwc(group_norm_silu_plain(xt, *args).float())
        if dt == torch.float32:
            np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
            continue
        diff = np.abs(got - ref)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(got), np.abs(ref)) + 1e-30)) - 7)
        assert np.all(diff <= ulp), (
            f"bf16: {int((diff > ulp).sum())} elements beyond one ulp, "
            f"{int((diff > 0).sum())} of {diff.size} differ")


# K3's (C, H=W) at every GroupNorm of the fused UNet forward at 512 px (a 64
# x 64 latent, as chip_smoke.py's survey records them), the same at 1024 px,
# the tiny configs' UNet at 64 and 256 px, and the VAE's levels at 512 px
UNET_512 = ((320, 64), (320, 32), (640, 32), (640, 16), (1280, 16), (1280, 8),
            (2560, 8), (2560, 16), (1920, 16), (1920, 32), (1280, 32), (960, 32),
            (960, 64), (640, 64))
K3_SHAPES = (UNET_512 + tuple((c, 2 * h) for c, h in UNET_512)
             + tuple((c, h) for c in (32, 64, 96, 128) for h in (4, 8, 16, 32))
             + tuple((c, h) for c in (128, 256, 512) for h in (64, 128, 256, 512)))


@pytest.mark.parametrize("itemsize", [2, 4])
def test_groupnorm_cluster_plan(itemsize):
    """K3's cut of each group into a cluster's slices: the slices tile the
    group exactly, none is empty, each is a multiple of 16 bytes, a cluster
    has 1, 2, 4 or 8 CTAs, and a resident slice with the kernel's 256 bytes
    of static shared memory fits the 227 KB a block may use. Every group of
    the fused 512 px UNet is resident; fp32 (2,960,128,128) and bf16
    (1,128,512,512) take the streaming path; the smallest UNet level
    ((2,1280,8,8), 2,560 elements) is one CTA."""
    plans = {}
    for c, h in K3_SHAPES:
        group = c // 32 * h * h
        n, s, resident = plans[(c, h)] = cluster_plan(group, itemsize)
        assert n in (1, 2, 4, 8) and s % 8 == 0 and (s * itemsize) % 16 == 0
        assert (n - 1) * s < group <= n * s
        assert resident == (s * itemsize <= SLICE_BYTES)
        assert not resident or s * itemsize + 256 <= 232_448
    assert all(plans[shape][2] for shape in UNET_512)
    assert plans[(1280, 8)][0] == 1 and plans[(960, 64)][0] == 8
    assert plans[(960, 128)][2] == (itemsize == 2)
    assert not plans[(128, 512)][2]
