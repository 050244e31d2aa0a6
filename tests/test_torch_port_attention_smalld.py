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


@pytest.mark.parametrize("d", [40, 80, 160])
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


def _library_bwd(seed: int, d: int):
    """(B, H, N, M) = (1, 2, 256, 256), bf16: the inputs of the port's
    backward plain versions, (q, k, v, lse, do, di) as torch tensors of
    (BH, N, D) = (2, 256, d) with the library's own saved o (for di) and lse,
    and the library's (dq, dk, dv) of jax.vjp through flash_attention, as
    fp32 numpy arrays of the same shape."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(1, 2, 256, d)).astype(np.float32) for _ in range(4))
    scale = d**-0.5
    as_j = lambda a: jnp.asarray(a, jnp.bfloat16)
    jq, jk, jv = map(as_j, (q, k, v))
    o, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, scale), jq, jk, jv)
    grads = vjp(as_j(do))
    _, lse = j_flash_residuals(jq, jk, jv, scale)

    flat = lambda a: np.array(a, np.float32).reshape(2, 256, d)
    tq, tk, tv, tdo, to = (torch.from_numpy(flat(a)).to(torch.bfloat16)
                           for a in (q, k, v, do, o.astype(jnp.float32)))
    tlse = torch.from_numpy(np.array(lse, np.float32).reshape(2, 256))
    refs = tuple(flat(g.astype(jnp.float32)) for g in grads)
    return (tq, tk, tv, tlse, tdo, PA.row_dot(to, tdo)), refs


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


@pytest.mark.parametrize("d", [40, 80, 160, 256])
def test_k5_plain_matches_library_bwd_bf16(interpret_pallas, d):
    """dQ of jax.vjp through the library flash_attention against
    flash_bwd_dq_plain on the library's own o and lse."""
    args, (dq_ref, _, _) = _library_bwd(500 + d, d)
    dq = PA.flash_bwd_dq_plain(*args, d**-0.5)
    assert dq.dtype == torch.bfloat16
    err = np.abs(dq.float().numpy() - dq_ref).max()
    assert err <= _ulp_bf16(dq_ref), (err, _ulp_bf16(dq_ref))


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
