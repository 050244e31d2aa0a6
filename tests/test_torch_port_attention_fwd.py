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
plain version at one ulp on 4096-key inputs.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
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


@pytest.mark.parametrize("d", [40, 512])
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
