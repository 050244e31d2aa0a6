"""The functions the card holds the redesigned K1, K4 and K5 to, on the CPU.

- K1: the port's smalld_attention_plain in bf16 against the JAX package's
  own Pallas kernel, reface_tpu.ops.attention_smalld.self_attention_smalld,
  run in interpret mode as tests/test_attention_smalld.py runs it, in both
  TPU layouts ("nn", "tn") and both modes (the first-256-key shift, and
  `fast` without one). N = 512, so the shift covers only half of the keys.
  d = 40, 80 and 160 (a 1024 px input's 1024 tokens) all run the card's
  Hopper kernel, d = 160 at its 192-column instance.
  Both sides take fp32 scores, round p = exp2(s - shift) to bf16 and sum the
  rounded p (the kernel's ones-column) and the PV product in fp32; they
  differ by fp32 summation order and the division before the final bf16
  rounding: at most one bf16 ulp of the largest |o|. The rule is not
  einsum_attention's (normalised fp32 weights rounded to bf16): the two
  differ, by less than K1's 5e-3 tolerance against einsum on the card.
- K4: flash_bwd_dkv_plain in bf16 against the dK, dV of the library
  flash_attention (the JAX package's _flash_attention) under jax.vjp, run in
  interpret mode, fed the library's own saved o (for di) and lse. Both round
  P^T and dS^T to bf16 for the products that read them and store bf16; the
  probabilities differ only by fp32 rounding (exp(s - m) / l against
  exp(s - lse)), which moves a rounded P by one bf16 ulp in few elements
  and changes a sum over 256 queries far below an output ulp: at most one
  bf16 ulp of the largest |dk| (|dv|).
- K5: flash_bwd_dq_plain in bf16 against the dQ of the same jax.vjp. Both
  round dS to bf16 for the dQ product (the library's ds.astype(k.dtype))
  and store bf16; at most one bf16 ulp of the largest |dq|. d = 40 and 80
  are the UNet's widths (the card's Hopper kernel); d = 256 is a width of
  the wide path (on the card dS and P rounded to bf16 into workspaces, then
  dQ = dS K and dK, dV as GEMMs), whose function is the same; d = 160 is a
  1024 px UNet's, which the library pads to 256 (the JAX _flash_attention
  pads every head to a multiple of 128) and the port's plain versions take
  at the real width.
- The workspaces: flash_bwd_ds_plain's dS and P, rounded to bf16 as the
  card stores them, fed to the backward products give
  flash_attention_bwd_plain's dq, dk and dv bit for bit, so the split at dS
  changes no value.

This file holds K1 in the "nn" layout, K4 and the workspaces; K1 in the
"tn" layout and K5 are in test_torch_port_attention_smalld_tn.py, K1's
rule against einsum in test_torch_port_attention_smalld_einsum.py (files
of at most 11 tests, so that tests/test_train.py is queued early under
--dist loadfile; the shared inputs are in test_torch_port_helpers.py).
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
@pytest.mark.parametrize("layout", ["nn"])
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


@pytest.mark.parametrize("d", [40, 80, 160])
def test_k4_plain_matches_library_bwd_bf16(interpret_pallas, d):
    """dK and dV of jax.vjp through the library flash_attention against
    flash_bwd_dkv_plain on the library's own o and lse."""
    args, (_, dk_ref, dv_ref) = _library_bwd(400 + d, d)
    dk, dv = PA.flash_bwd_dkv_plain(*args, d**-0.5)
    assert dk.dtype == dv.dtype == torch.bfloat16
    for name, got, ref in (("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= _ulp_bf16(ref), (name, err, _ulp_bf16(ref))


def test_workspaces_feed_the_backward_bit_for_bit():
    """(BH, N, M, D) = (2, 96, 100, 256), bf16: the dS and P workspaces of
    flash_bwd_ds_plain ((BH, N, ds_pitch(M)), 0 at the 4 padding keys), fed
    to the products, give flash_attention_bwd_plain's dq, dk and dv exactly."""
    rng = np.random.default_rng(600)
    q, do = (_bf16_t(rng.normal(size=(2, 96, 256)).astype(np.float32)) for _ in range(2))
    k, v = (_bf16_t(rng.normal(size=(2, 100, 256)).astype(np.float32)) for _ in range(2))
    scale = 256**-0.5
    o, lse = PA.flash_attention_fwd_plain(q, k, v, scale)
    ds, p = PA.flash_bwd_ds_plain(q, k, v, lse, do, PA.row_dot(o, do), scale)
    assert ds.shape == p.shape == (2, 96, PA.ds_pitch(100)) == (2, 96, 104)
    assert ds.dtype == p.dtype == torch.bfloat16
    assert not ds[..., 100:].any() and not p[..., 100:].any()
    ds, p = ds[..., :100], p[..., :100]
    want = PA.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    got = (PA._dq(q, k, ds),) + PA._dkv(q, k, v, do, p, ds)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(g, w), name
