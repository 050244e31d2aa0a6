"""The functions the card holds the redesigned K1 and K4 to, on the CPU.

- K1: the port's smalld_attention_plain in bf16 against the JAX package's
  own Pallas kernel, reface_tpu.ops.attention_smalld.self_attention_smalld,
  run in interpret mode as tests/test_attention_smalld.py runs it, in both
  TPU layouts ("nn", "tn") and both modes (the first-256-key shift, and
  `fast` without one). N = 512, so the shift covers only half of the keys.
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
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_port_helpers import j_flash_residuals

import reface_tpu.ops.attention_smalld as S
from reface_tpu.ops.attention import _flash_attention as j_flash
from reface_tpu_torch.ops import attention as PA
from reface_tpu_torch.ops.attention_smalld import einsum_attention, smalld_attention_plain

_K1_EINSUM_TOL = 5e-3  # chip_smoke.py's TOL["K1"]["bf16"]


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _ulp_bf16(x: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of x (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


def _qkv(seed: int, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _bf16_t(a: np.ndarray):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("layout", ["nn", "tn"])
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


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("fast", [False, True])
def test_k1_rule_is_not_einsum(fast, d):
    """The TPU kernel's rounding is not einsum_attention's: they differ, by
    less than the tolerance that holds K1 to einsum on the card."""
    q, k, v = (_bf16_t(a) for a in _qkv(300 + d, (2, 512, d)))
    scale = d**-0.5
    got = smalld_attention_plain(q, k, v, scale, fast)
    err = (got.float() - einsum_attention(q, k, v, scale).float()).abs().max().item()
    assert 0.0 < err < _K1_EINSUM_TOL, err


@pytest.mark.parametrize("d", [40, 80])
def test_k4_plain_matches_library_bwd_bf16(interpret_pallas, d):
    """(B, H, N, M) = (1, 2, 256, 256), bf16: dK and dV of jax.vjp through
    the library flash_attention against flash_bwd_dkv_plain on the
    library's own o and lse."""
    rng = np.random.default_rng(400 + d)
    q, k, v, do = (rng.normal(size=(1, 2, 256, d)).astype(np.float32) for _ in range(4))
    scale = d**-0.5
    as_j = lambda a: jnp.asarray(a, jnp.bfloat16)
    jq, jk, jv = map(as_j, (q, k, v))
    o, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, scale), jq, jk, jv)
    _, dk_ref, dv_ref = vjp(as_j(do))
    _, lse = j_flash_residuals(jq, jk, jv, scale)

    flat = lambda a: torch.from_numpy(np.array(a, np.float32).reshape(2, 256, d))
    tq, tk, tv, tdo, to = (flat(a).to(torch.bfloat16) for a in (q, k, v, do, o.astype(jnp.float32)))
    tlse = torch.from_numpy(np.array(lse, np.float32).reshape(2, 256))
    dk, dv = PA.flash_bwd_dkv_plain(tq, tk, tv, tlse, tdo, PA.row_dot(to, tdo), scale)
    assert dk.dtype == dv.dtype == torch.bfloat16
    for name, got, ref in (("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        ref = np.asarray(ref.astype(jnp.float32)).reshape(2, 256, d)
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= _ulp_bf16(ref), (name, err, _ulp_bf16(ref))
