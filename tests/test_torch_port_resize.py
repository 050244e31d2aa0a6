"""reface_tpu_torch's resizes (bilinear without and with antialiasing) and
adaptive average pooling against the JAX package's, on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_port_helpers import nchw, nhwc
from test_torch_port_helpers import one_torch_thread

from reface_tpu.ops.pooling import adaptive_avg_pool2d as j_pool
from reface_tpu.ops.resize import resize_bilinear_no_aa as j_resize
from reface_tpu_torch.ops.pooling import adaptive_avg_pool2d as p_pool
from reface_tpu_torch.ops.resize import resize_bilinear_aa, resize_bilinear_no_aa

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.mark.parametrize("shape,out", [((2, 64, 64, 1), 8), ((1, 33, 47, 3), 20),
                                       ((1, 8, 8, 2), 16)])
def test_resize_no_aa_matches_jax(shape, out):
    x = np.random.default_rng(2).uniform(size=shape).astype(np.float32)
    ref = j_resize(jnp.asarray(x), out, out)
    got = resize_bilinear_no_aa(nchw(x), out, out)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-6, rtol=0)


def test_resize_aa_matches_jax_image_resize():
    """The CLIP target crop: jax.image.resize bilinear antialiases on shrink."""
    import jax

    x = np.random.default_rng(3).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 224, 224, 3), "bilinear")
    got = resize_bilinear_aa(nchw(x), 224, 224)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5, rtol=0)
    x = np.random.default_rng(4).uniform(size=(1, 512, 512, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, 224, 224, 3), "bilinear")
    got = resize_bilinear_aa(nchw(x), 224, 224)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,m", [(224, 256), (188, 112), (64, 20)])
def test_adaptive_pool_matches_jax(n, m):
    x = np.random.default_rng(5).normal(size=(2, n, n, 3)).astype(np.float32)
    ref = j_pool(jnp.asarray(x), m, m)
    got = p_pool(nchw(x), m, m)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5, rtol=0)
