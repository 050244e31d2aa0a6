"""The full loss's DDIM reconstruction and its VAE decoder path against the
JAX package, on the CPU, fp32: ddim_reconstruct, the decoder's remat and
attention routing, and the flash attention's plain version at the decoder's
d=512 against the library's (interpret mode).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_port_helpers import assert_close, nchw, nhwc, one_torch_thread

from reface_tpu.core.schedules import DiffusionSchedule as JSchedule
from reface_tpu.diffusion import losses as JLoss
from reface_tpu.ops.attention import _flash_attention as j_flash
from reface_tpu_torch.core.schedules import DiffusionSchedule
from reface_tpu_torch.diffusion import losses as PLoss
from reface_tpu_torch.nn.layers import GroupNorm32
from reface_tpu_torch.nn.vae import AutoencoderKL, VAEConfig
from reface_tpu_torch.ops import attention as PA
from reface_tpu_torch.ops import groupnorm as PG
from reface_tpu_torch.pipelines import train as PT
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


# ------------------------------------------------------------------ modules


# ------------------------------------------------------------------ pieces


@pytest.mark.parametrize("k,t_new", [(4, None), (2, None), (4, 3)])
def test_ddim_reconstruct_matches_jax(k, t_new):
    """The k-step chain with an oracle unet_fn (a fixed function of x9, t
    and the conditioning): the collected latents and the final sample within
    1e-5 of the JAX package's lax.scan."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    rest = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
    cond = rng.normal(size=(2, 1, 4)).astype(np.float32)
    w = (rng.normal(size=(9, 4)) * 0.3).astype(np.float32)

    def j_unet(x9, t, c):
        return jnp.tanh(x9 @ w + c[:, None] * 0.1) * (1.0 + t[:, None, None, None] / 1000.0)

    def p_unet(x9, t, c):
        h = torch.einsum("bchw,cd->bdhw", x9, torch.from_numpy(w))
        h = torch.tanh(h + c.reshape(2, 4, 1, 1) * 0.1)
        return h * (1.0 + t.reshape(-1, 1, 1, 1) / 1000.0)

    ref, ref_final = JLoss.ddim_reconstruct(
        j_unet, jnp.asarray(x), jnp.asarray(rest), jnp.asarray(cond),
        JSchedule.create(), k=k, t_new=t_new)
    got, final = PLoss.ddim_reconstruct(
        p_unet, nchw(x), nchw(rest), torch.from_numpy(cond),
        DiffusionSchedule.create(), k=k, t_new=t_new)
    assert len(got) == len(ref) == 3
    for g, r in zip(got + [final], list(ref) + [ref_final]):
        assert_close(nhwc(g), r, atol=1e-5)


# ------------------------------------------------------------ the full loss

def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_vae_remat_keeps_the_gradients():
    """VAEConfig.remat recomputes the decoder's blocks in the backward: the
    decode and the gradient into the latent are those without it (2e-6
    relative L2, fp32 on the CPU), under an outer checkpoint as the towers
    run it too."""
    from torch.utils.checkpoint import checkpoint

    cfg = p_tiny(64).vae
    z = torch.from_numpy(np.random.default_rng(10).normal(size=(2, 4, 8, 8)).astype(np.float32))
    plain = AutoencoderKL(cfg, device="cpu")
    PT.init_params(plain, seed=3, dezero=True)
    plain.requires_grad_(False)
    remat = AutoencoderKL(dataclasses.replace(cfg, remat=True), device="cpu")
    remat.load_state_dict(plain.state_dict())
    remat.requires_grad_(False)
    grads = []
    for net, outer in ((plain, False), (remat, False), (remat, True)):
        zz = z.clone().requires_grad_()
        out = checkpoint(net.decode, zz, use_reentrant=False) if outer else net.decode(zz)
        out.square().mean().backward()
        grads.append((out.detach(), zz.grad))
    for out, g in grads[1:]:
        assert _rel(out, grads[0][0]) <= 2e-6 and _rel(g, grads[0][1]) <= 2e-6


def test_vae_attention_routing(monkeypatch):
    """The VAE built for training (VAEConfig.remat) sends its decoder's
    mid-block attention to FlashAttention, in a first pass without gradients
    as in one with them; the serving VAE and both encoders go to K2
    (wide_attention). Every GroupNorm of the passes without gradients goes
    to K3 (without the SiLU), none of the pass with them. Meta tensors that
    claim to be on the card, with the wrappers replaced by recorders."""
    calls, k3 = [], []
    monkeypatch.setattr(PG, "group_norm_silu",
                        lambda x, scale, bias, groups, eps, silu: k3.append(silu) or x)
    monkeypatch.setattr(PA, "wide_attention",
                        lambda q, k, v, scale: calls.append(("k2", tuple(q.shape))) or q)
    monkeypatch.setattr(PA.FlashAttention, "apply",
                        lambda q, k, v, scale: calls.append(("flash", tuple(q.shape))) or q)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    cfg = VAEConfig(ch=8, ch_mult=(1, 2, 4, 64), num_res_blocks=1, dtype=torch.float32)
    z = torch.zeros(2, 4, 32, 32, device="meta")
    img = torch.zeros(2, 3, 256, 256, device="meta")
    serving = AutoencoderKL(cfg, device="meta")
    training = AutoencoderKL(dataclasses.replace(cfg, remat=True), device="meta")
    with torch.no_grad():
        serving.decode(z)
        serving.encode(img)
        training.decode(z)
        training.encode(img)
    norms = sum(isinstance(m, GroupNorm32) for m in serving.modules())
    assert len(k3) == 2 * norms and not any(k3)
    training.decode(z.clone().requires_grad_())
    assert len(k3) == 2 * norms
    shape = (2, 1024, 512)
    assert calls == [("k2", shape), ("k2", shape), ("flash", shape), ("k2", shape),
                     ("flash", shape)]


# ------------------------------------------------------- flash plain, D = 512

def test_flash_plain_matches_library_at_d512(interpret_pallas):
    """flash_attention_fwd_plain and flash_attention_bwd_plain at the VAE's
    head width, d = 512 (one head, N = M = 128), against the library kernels
    in interpret mode (jax.vjp of the JAX package's _flash_attention, which
    does not pad a head this wide). fp32 both sides: 2e-5 max abs covers the
    summation orders over a depth of 512."""
    rng = np.random.default_rng(512)
    q, k, v, do = (rng.normal(size=(2, 1, 128, 512)).astype(np.float32) for _ in range(4))
    scale = 512**-0.5
    o_ref, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, scale), *map(jnp.asarray, (q, k, v)))
    grads_ref = vjp(jnp.asarray(do))
    flat = lambda a: torch.from_numpy(a.reshape(2, 128, 512))
    o, lse = PA.flash_attention_fwd_plain(flat(q), flat(k), flat(v), scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref).reshape(2, 128, 512),
                               atol=2e-5, rtol=0)
    s = np.einsum("bnd,bmd->bnm", q[:, 0], k[:, 0]).astype(np.float64) * scale
    lse_ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=2e-5, rtol=0)
    got = PA.flash_attention_bwd_plain(flat(q), flat(k), flat(v), o, lse, flat(do), scale)
    for name, g, ref in zip(("dq", "dk", "dv"), got, grads_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref).reshape(2, 128, 512),
                                   atol=2e-5, rtol=0, err_msg=name)


def test_flash_wrappers_take_wide_heads():
    """On the CPU the wrappers compute their plain versions at d = 512 as at
    any width, and FlashAttention differentiates; the operand check takes
    d = 512 and the widths the wrappers pad to a multiple of 128 (136, 160),
    and refuses what no kernel runs: D above 512 or not a multiple of 8."""
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, n, 512)).astype(np.float32))
                   for n in (70, 90, 90, 70))
    scale = 512**-0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(PA.FlashAttention.apply(*leaves, scale), leaves, do)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(PA.einsum_attention(*ref_leaves, scale), ref_leaves, do)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=2e-6, rtol=0)
    meta = lambda d: torch.zeros(1, 128, d, device="meta")
    for d in (164, 640, 1024):
        with pytest.raises(ValueError, match="multiple of"):
            PA._check_flash("flash", meta(d), meta(d), meta(d))
    for d in (136, 160, 512):
        with pytest.raises(ValueError, match="CUDA"):  # the width itself is taken
            PA._check_flash("flash", meta(d), meta(d), meta(d))
