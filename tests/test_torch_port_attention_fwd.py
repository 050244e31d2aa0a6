"""The function the card holds K2 to, on the CPU: the port's
flash_attention_fwd_plain (its o) in bf16 against the library
flash_attention forward *without* residuals, which is what the JAX package's
serving path calls (reface_tpu/ops/attention.py:_flash_attention), run in
interpret mode.

Both sides take fp32 scores, sum the fp32 probabilities into the row sum
and round them to bf16 only for the PV product (flash_attention.py:447-471).
With M <= 256 the library runs one key block, so both round p relative to
the same (global) row max, and the outputs differ only by fp32 summation
order before the final bf16 rounding: at most one bf16 ulp of the largest
|o|. A kernel that rounded p before the row sum (K1's rule) would also
pass at this size, which is why chip_smoke.py holds the CUDA kernel to this
plain version at one ulp on 4096-key inputs. At d = 160 the library runs
the head zero-padded to 256 (the JAX _flash_attention pads every head to a
multiple of 128), and the plain version takes the real width.

The card runs a head above 128 that is not a multiple of 128 zero-padded
as the JAX package does (PA.pad_head_dim), with the scale of the real
width, and slices the results: in fp32 that is the plain version at the
real width.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from reface_tpu.ops.attention import _flash_attention as j_flash
from reface_tpu_torch.ops import attention as PA


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _ulp_bf16(x: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of x (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


@pytest.mark.parametrize("d", [40, 160, 512])
def test_k2_plain_matches_library_forward_bf16(interpret_pallas, d):
    """(B, H, N, M) = (1, 2, 128, 256), bf16 inputs from a numpy seed."""
    rng = np.random.default_rng(100 + d)
    n, m = 128, 256
    q = rng.normal(size=(1, 2, n, d)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, m, d)).astype(np.float32) for _ in range(2))
    scale = d**-0.5
    as_j = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = np.asarray(j_flash(as_j(q), as_j(k), as_j(v), scale).astype(jnp.float32))

    as_t = lambda a: torch.from_numpy(a.reshape(2, a.shape[2], d)).to(torch.bfloat16)
    o, _ = PA.flash_attention_fwd_plain(as_t(q), as_t(k), as_t(v), scale)
    assert o.dtype == torch.bfloat16
    got = o.float().numpy().reshape(ref.shape)
    err = np.abs(got - ref).max()
    assert err <= _ulp_bf16(ref), (err, _ulp_bf16(ref))


@pytest.mark.parametrize("what", ["forward", "backward"])
def test_padding_keeps_the_function(what):
    """(BH, N, M, D) = (2, 96, 100, 160), fp32: pad_head_dim (to 256), the
    plain forward (o, lse) or backward (dq, dk, dv) at the real width's
    scale, then sliced back to 160, against the plain version at 160."""
    rng = np.random.default_rng(700)
    q, do = (torch.from_numpy(rng.normal(size=(2, 96, 160)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(2, 100, 160)).astype(np.float32))
            for _ in range(2))
    scale = 160**-0.5
    padded = PA.pad_head_dim(q, k, v, do)
    assert PA.padded_head_dim(160) == 256 and all(t.shape[-1] == 256 for t in padded)
    assert all(torch.equal(t[..., :160], u) and not t[..., 160:].any()
               for t, u in zip(padded, (q, k, v, do)))
    if what == "forward":
        want = PA.flash_attention_fwd_plain(q, k, v, scale)
        got = PA.flash_attention_fwd_plain(*padded[:3], scale)
        got = (got[0][..., :160], got[1])
    else:
        o, lse = PA.flash_attention_fwd_plain(q, k, v, scale)
        want = PA.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
        po = F.pad(o, (0, 96))
        got = tuple(g[..., :160] for g in PA.flash_attention_bwd_plain(
            *padded[:3], po, lse, padded[3], scale))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-6, rtol=0)
