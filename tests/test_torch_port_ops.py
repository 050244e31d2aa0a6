"""The port's kernel modules on the CPU: each wrapper's plain version against
the JAX package's function (the Pallas kernels in interpret mode, the way
tests/test_attention_smalld.py runs them), and the dispatch routing.

The CUDA kernels themselves run only on the card; chip_smoke.py holds each
one against these plain versions there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_port_helpers import nchw, nhwc

import reface_tpu.ops.attention_smalld as JS
from reface_tpu.ops.attention import _einsum_attention as j_einsum
from reface_tpu.ops.attention import multi_head_attention as j_mha
from reface_tpu.ops.groupnorm import group_norm_silu as j_gn
from reface_tpu_torch.ops import attention as PA
from reface_tpu_torch.ops.attention_smalld import einsum_attention, self_attention_smalld
from reface_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _qkv(bh, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(bh, n, d)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("d", [40, 80])
def test_plain_attention_matches_jax(interpret_pallas, d):
    """Plain version vs _einsum_attention and vs self_attention_smalld in
    both TPU layouts (interpret mode). fp32 throughout: 2e-6 covers the
    different summation orders of fp32 products over N=512 keys."""
    q, k, v = _qkv(4, 512, d, seed=d)
    scale = d**-0.5
    got = self_attention_smalld(*map(torch.from_numpy, (q, k, v))).numpy()
    ref = j_einsum(*map(jnp.asarray, (q[None], k[None], v[None])), scale)[0]
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-6, rtol=0)
    for layout in ("nn", "tn"):
        ref = JS.self_attention_smalld(*map(jnp.asarray, (q, k, v)),
                                       block_q=128, layout=layout)
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-6, rtol=0)


def test_wide_attention_plain_matches_jax():
    """K2's plain version (one head, wide d, n != m) vs _einsum_attention."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 64, 512)).astype(np.float32)
    k = rng.normal(size=(2, 96, 512)).astype(np.float32)
    v = rng.normal(size=(2, 96, 512)).astype(np.float32)
    got = PA.wide_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    ref = j_einsum(*map(jnp.asarray, (q[:, None], k[:, None], v[:, None])),
                   512**-0.5)[:, 0]
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-6, rtol=0)


@pytest.mark.parametrize("impl", ["auto", "fast", "einsum"])
def test_multi_head_attention_cpu_matches_jax(impl):
    """On the CPU every impl takes the plain product, as JAX does off-TPU."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 128, 64)).astype(np.float32)
    k = rng.normal(size=(2, 32, 64)).astype(np.float32)
    v = rng.normal(size=(2, 32, 64)).astype(np.float32)
    got = PA.multi_head_attention(*map(torch.from_numpy, (q, k, v)), 4, impl=impl)
    ref = j_mha(*map(jnp.asarray, (q, k, v)), 4, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6, rtol=0)


def test_attention_routing(monkeypatch):
    """The dispatch picks K1 / K2 / FlashAttention / plain by shape as the TPU
    routing does.

    The wrappers are replaced by recorders and the tensors claim to be on
    the card, so the routing decision itself is what is checked here."""
    calls = []
    monkeypatch.setattr(PA, "self_attention_smalld",
                        lambda q, k, v, scale, fast: calls.append(("k1", q.shape, fast)) or q)
    monkeypatch.setattr(PA, "wide_attention",
                        lambda q, k, v, scale: calls.append(("k2", q.shape)) or q)
    monkeypatch.setattr(PA.FlashAttention, "apply",
                        lambda q, k, v, scale: calls.append(("flash", q.shape)) or q)
    monkeypatch.setattr(PA, "einsum_attention",
                        lambda q, k, v, scale: calls.append(("plain", q.shape)) or q)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    z = lambda b, h, n, d: torch.zeros(b, h, n, d)
    PA.attention_bhnd(z(2, 8, 4096, 40), z(2, 8, 4096, 40), z(2, 8, 4096, 40))
    PA.attention_bhnd(z(4, 8, 1024, 80), z(4, 8, 1024, 80), z(4, 8, 1024, 80),
                      impl="fast")
    PA.attention_bhnd(z(2, 1, 4096, 512), z(2, 1, 4096, 512), z(2, 1, 4096, 512))
    PA.attention_bhnd(z(4, 8, 256, 160), z(4, 8, 256, 160), z(4, 8, 256, 160))
    PA.attention_bhnd(z(2, 8, 4096, 40), z(2, 8, 4096, 40), z(2, 8, 4096, 40),
                      impl="einsum")
    assert calls == [("k1", (16, 4096, 40), False), ("k1", (32, 1024, 80), True),
                     ("k2", (2, 4096, 512)), ("plain", (4, 8, 256, 160)),
                     ("plain", (2, 8, 4096, 40))]
    # training: "flash" at the UNet's 4096 and 1024 tokens, plain below
    calls.clear()
    for n, d in ((4096, 40), (1024, 80), (256, 160), (64, 160)):
        PA.attention_bhnd(z(4, 8, n, d), z(4, 8, n, d), z(4, 8, n, d), impl="flash")
    assert calls == [("flash", (32, 4096, 40)), ("flash", (32, 1024, 80)),
                     ("plain", (4, 8, 256, 160)), ("plain", (4, 8, 64, 160))]


def test_kernel_wrappers_refuse_what_they_cannot_take():
    """On a non-CPU, non-CUDA tensor the wrappers raise; they never fall back."""
    q = torch.zeros(2, 512, 40, device="meta")
    with pytest.raises(ValueError):
        self_attention_smalld(q, q, q)
    with pytest.raises(ValueError):
        PA.wide_attention(q, q, q)
    with pytest.raises(ValueError):
        group_norm_silu(torch.zeros(1, 32, 8, 8, device="meta"),
                        torch.ones(32), torch.zeros(32))


def test_kernel_wrappers_refuse_to_cut_gradients():
    """K1/K2/K3 have no backward: on a non-CPU tensor that requires grad
    each wrapper raises (naming the differentiable route) instead of
    returning a detached output; under no_grad it goes on to its checks."""
    q = torch.zeros(2, 512, 40, device="meta", requires_grad=True)
    x = torch.zeros(1, 32, 8, 8, device="meta", requires_grad=True)
    calls = [lambda: self_attention_smalld(q, q, q),
             lambda: PA.wide_attention(q, q, q),
             lambda: group_norm_silu(x, torch.ones(32), torch.zeros(32))]
    for call, route in zip(calls, ("flash", "flash", "fused_groupnorm=False")):
        with pytest.raises(RuntimeError, match=route):
            call()
        with torch.no_grad(), pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("shape,groups,eps,silu", [
    ((2, 8, 8, 64), 32, 1e-5, True),
    ((1, 16, 16, 96), 32, 1e-6, False),
    ((3, 4, 4, 12), 4, 1e-5, True),
])
def test_groupnorm_plain_matches_jax(shape, groups, eps, silu):
    """K3's plain version vs group_norm_silu (the JAX _reference_impl off-TPU),
    NHWC there and NCHW here; 1e-5 covers fp32 reduction order."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    scale = rng.normal(size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    ref = j_gn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
               groups=groups, eps=eps, silu=silu)
    args = (torch.from_numpy(scale), torch.from_numpy(bias), groups, eps, silu)
    got = group_norm_silu(nchw(x), *args)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.numpy(), group_norm_silu_plain(nchw(x), *args).numpy())


def test_einsum_attention_rounds_probs_to_v_dtype():
    """bf16 inputs: fp32 logits and softmax, probabilities cast to bf16."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(2, 64, 40))
    out = einsum_attention(q, k, v, 40**-0.5)
    w = torch.softmax(q.float() @ k.float().transpose(-1, -2) * 40**-0.5, -1)
    ref = w.to(torch.bfloat16) @ v
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
