"""K1 in the TPU kernel's "tn" layout and K5 (flash_bwd_dq_plain) on the CPU,
as test_torch_port_attention_smalld.py describes them: K1 against the JAX
Pallas kernel in interpret mode, K5 against the dQ of jax.vjp through the
library flash_attention, each within one bf16 ulp of the largest output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import interpret_pallas
from test_torch_port_helpers import one_torch_thread
from test_torch_port_helpers import ulp_bf16 as _ulp_bf16
from test_torch_port_helpers import smalld_qkv as _qkv
from test_torch_port_helpers import bf16_t as _bf16_t
from test_torch_port_helpers import library_bwd as _library_bwd

import reface_tpu.ops.attention_smalld as S
from reface_tpu_torch.ops import attention as PA
from reface_tpu_torch.ops.attention_smalld import smalld_attention_plain

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("layout", ["tn"])
def test_k1_plain_matches_pallas_kernel_bf16(interpret_pallas, layout, fast, d):
    """(BH, N, D) = (2, 512, d), bf16, block_q 256 (two query blocks)."""
    q, k, v = _qkv(300 + d, (2, 512, d))
    scale = d**-0.5
    as_j = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = S.self_attention_smalld(as_j(q), as_j(k), as_j(v), scale=scale, block_q=256,
                                  fast=fast, layout=layout)
    ref = np.asarray(ref.astype(jnp.float32))
    got = smalld_attention_plain(_bf16_t(q), _bf16_t(k), _bf16_t(v), scale, fast)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= _ulp_bf16(ref), (err, _ulp_bf16(ref))


@pytest.mark.parametrize("d", [40, 80, 160, 256])
def test_k5_plain_matches_library_bwd_bf16(interpret_pallas, d):
    """dQ of jax.vjp through the library flash_attention against
    flash_bwd_dq_plain on the library's own o and lse."""
    args, (dq_ref, _, _) = _library_bwd(500 + d, d)
    dq = PA.flash_bwd_dq_plain(*args, d**-0.5)
    assert dq.dtype == torch.bfloat16
    err = np.abs(dq.float().numpy() - dq_ref).max()
    assert err <= _ulp_bf16(dq_ref), (err, _ulp_bf16(dq_ref))
