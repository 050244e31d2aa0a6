"""K1's rounding rule (smalld_attention_plain) is not einsum_attention's: the
two differ, by less than the tolerance that holds K1 to einsum on the card
(test_torch_port_attention_smalld.py describes the rule).
"""

import pytest

from test_torch_port_helpers import smalld_qkv as _qkv
from test_torch_port_helpers import one_torch_thread
from test_torch_port_helpers import bf16_t as _bf16_t

from reface_tpu_torch.ops.attention_smalld import einsum_attention, smalld_attention_plain

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

_K1_EINSUM_TOL = 5e-3  # chip_smoke.py's TOL["K1"]["bf16"]


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("fast", [False, True])
def test_k1_rule_is_not_einsum(fast, d):
    """The TPU kernel's rounding is not einsum_attention's: they differ, by
    less than the tolerance that holds K1 to einsum on the card."""
    q, k, v = (_bf16_t(a) for a in _qkv(300 + d, (2, 512, d)))
    scale = d**-0.5
    got = smalld_attention_plain(q, k, v, scale, fast)
    err = (got.float() - einsum_attention(q, k, v, scale).float()).abs().max().item()
    assert 0.0 < err < _K1_EINSUM_TOL, err
