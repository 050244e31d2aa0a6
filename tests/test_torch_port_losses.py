"""The port's full training loss (reface_tpu_torch.diffusion.losses and the
recon path of pipelines.train) against the JAX package, on the CPU.

Tiny configs (tiny_swap_config(64), ReconLossConfig(ddim_steps=2,
lpips_scales=(1, 2))), fp32 on both sides, inputs from numpy seeds, JAX's own
draws reproduced from its split key and passed to the port; gradients are
compared by name through reface_tpu_torch.ckpt.from_jax. The landmark
auxiliary head's tests are in test_torch_port_losses_head.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_port_helpers import (
    assert_close,
    check_full_loss_matches_jax,
    full_loss_setup,
    init_jax,
    jax_draws,
    load,
    nchw,
    nhwc,
    one_torch_thread,
    port_full_step,
)

from reface_tpu.ckpt.convert import convert_lpips
from reface_tpu.core.schedules import DiffusionSchedule as JSchedule
from reface_tpu.diffusion import losses as JLoss
from reface_tpu.nn.lpips import LPIPS as JLPIPS
from reface_tpu.ops.attention import _flash_attention as j_flash
from reface_tpu.pipelines import train as JT
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.core.schedules import DiffusionSchedule
from reface_tpu_torch.diffusion import losses as PLoss
from reface_tpu_torch.nn.lpips import LPIPS
from reface_tpu_torch.nn.vae import AutoencoderKL, VAEConfig
from reface_tpu_torch.ops import attention as PA
from reface_tpu_torch.pipelines import train as PT
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


# ------------------------------------------------------------------ modules

def test_lpips_matches_jax():
    """LPIPS distances at 64 px within 2e-5 of reface_tpu.nn.lpips (fp32; the
    AlexNet convs sum in another order), and the port's state dict goes back
    through the JAX package's convert_lpips to the same flax tree exactly."""
    rng = np.random.default_rng(0)
    x, y = (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    params = init_jax(JLPIPS(), jnp.asarray(x), jnp.asarray(y), seed=1)
    ref = JLPIPS().apply(params, jnp.asarray(x), jnp.asarray(y))
    sd = from_jax.lpips_from_jax(params)
    assert set(sd) == {f"net.layers.{i}.{w}" for i in (0, 3, 6, 8, 10)
                       for w in ("weight", "bias")} | {f"lin.{i}.1.weight" for i in range(5)}
    net = load(LPIPS(device="cpu"), sd)
    assert_close(net(nchw(x), nchw(y)), ref, atol=2e-5)
    back = convert_lpips(jax.eval_shape(lambda: params), {k: v.numpy() for k, v in sd.items()})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------ pieces

@pytest.mark.parametrize("t_new,k", [(999, 4), (999, 2), (999, 50), (10, 4), (3, 4)])
def test_recon_timestep_seq_matches_jax(t_new, k):
    assert PLoss.recon_timestep_seq(t_new, k) == JLoss.recon_timestep_seq(t_new, k)
    if (t_new, k) == (999, 4):
        assert PLoss.recon_timestep_seq(t_new, k) == [748, 499, 250, 1]


@pytest.mark.parametrize("size", [64, 32, 16])
def test_avg_pool_to_matches_jax(size):
    x = np.random.default_rng(6).normal(size=(2, 64, 64, 3)).astype(np.float32)
    got = PLoss.avg_pool_to(nchw(x), size)
    assert_close(nhwc(got), JLoss.avg_pool_to(jnp.asarray(x), size), atol=1e-6)


@pytest.mark.parametrize("hw,size", [(8, 64), (32, 256)])
def test_keep_mask_upsampling_matches_jax_resize(hw, size):
    """The ID mask: jax.image.resize(..., "bilinear") upsamples with
    half-pixel centres, F.interpolate(align_corners=False) (1e-6)."""
    m = (np.random.default_rng(7).uniform(size=(2, hw, hw, 1)) > 0.5).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(m), (2, size, size, 1), "bilinear")
    assert_close(nhwc(PLoss.upsample_keep_mask(nchw(m), size)), ref, atol=1e-6)


def test_id_cosine_loss_matches_jax():
    rng = np.random.default_rng(8)
    w = rng.normal(size=(12, 5)).astype(np.float32)
    a, b = (rng.normal(size=(3, 2, 2, 3)).astype(np.float32) for _ in range(2))

    def j_embed(x):
        f = x.reshape(x.shape[0], -1) @ w
        return f / jnp.linalg.norm(f, axis=-1, keepdims=True)

    def p_embed(x):
        f = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1) @ torch.from_numpy(w)
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    ref = JLoss.id_cosine_loss(j_embed, jnp.asarray(a), jnp.asarray(b))
    a_t = nchw(a).requires_grad_()
    got = PLoss.id_cosine_loss(p_embed, a_t, nchw(b).requires_grad_())
    assert_close(got, ref, atol=1e-6)
    got.backward()
    g_ref = jax.grad(lambda x: JLoss.id_cosine_loss(j_embed, x, jnp.asarray(b)))(jnp.asarray(a))
    assert_close(nhwc(a_t.grad), g_ref, atol=1e-6)


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


@pytest.fixture(scope="module")
def tiny():
    return full_loss_setup()


def test_full_loss_matches_jax(tiny):
    """The full loss (eps-MSE + the 2-step reconstruction with ID and LPIPS
    losses): loss, metrics and every trainable gradient against the JAX
    package; the frozen towers, LPIPS among them, get no gradient (the
    limits are in test_torch_port_helpers.check_full_loss_matches_jax; the
    landmark aux head is in test_torch_port_losses_head.py)."""
    check_full_loss_matches_jax(
        tiny, want_metrics={"loss_simple", "id_loss", "lpips_loss", "loss"},
        frozen={"vae", "conditioner", "lpips"})


@pytest.fixture(scope="module")
def monolith(tiny):
    _, params, batch, key = tiny
    draws = jax_draws(key, 2, 8, JT.TrainConfig())
    p = from_jax.swap_from_jax({k: v for k, v in params.items() if k != "landmark_head"})
    step, _, state = port_full_step(p)
    loss, metrics = step.loss_and_grads(state.modules, batch, draws)
    grads = {k: v.grad.clone() for k, v in PT.named_params(state.modules).items()
             if v.grad is not None}
    return p, batch, draws, loss, metrics, grads


@pytest.mark.parametrize("level", [1, 2])
def test_split_grad_matches_monolith(monolith, level):
    """split_grad 1 (recon backward, then eps backward) and 2 (the recon
    portion cut at the collected latents) leave the monolith's loss, metrics
    and gradients: 1e-6 relative (fp32; the same products, summed into .grad
    in another order)."""
    p, batch, draws, loss, metrics, grads = monolith
    step, _, state = port_full_step(p, PT.TrainConfig(split_grad=level))
    loss_s, metrics_s = step.loss_and_grads(state.modules, batch, draws)
    assert set(metrics_s) == set(metrics)
    assert abs(loss_s.item() / loss.item() - 1) < 1e-6
    for k, v in metrics.items():
        assert abs(metrics_s[k].item() / v.item() - 1) < 1e-6, k
    named = PT.named_params(state.modules)
    assert {k for k, v in named.items() if v.grad is not None} == set(grads)
    total = float(sum(g.double().pow(2).sum() for g in grads.values()) ** 0.5)
    for k, g in grads.items():
        diff = float((named[k].grad - g).norm())
        assert diff <= 1e-6 * max(float(g.norm()), 1e-3 * total), k


def test_full_train_step_updates_only_trainables(monolith):
    """One full-loss optimizer step: finite metrics, the trainables with a
    gradient move, the frozen towers (LPIPS among them) stay bit-identical."""
    p, batch, draws, *_ = monolith
    step, _, state = port_full_step(p, PT.TrainConfig(warmup_steps=1))
    before = {k: v.detach().clone() for k, v in PT.named_params(state.modules).items()}
    for _ in range(2):  # the warmup's first step has a learning rate of ~0
        state, metrics = step(state, batch, draws)
    assert all(torch.isfinite(v) for v in metrics.values())
    labels = PT.trainable_labels(before)
    assert "lpips" in state.params()
    for name, new in PT.named_params(state.modules).items():
        moved = not torch.equal(new, before[name])
        if labels[name] == "freeze":
            assert not moved, name
        elif new.grad is not None and new.grad.any():
            assert moved, name


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
    (wide_attention). Meta tensors that claim to be on the card, with the
    wrappers replaced by recorders."""
    calls = []
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
    training.decode(z.clone().requires_grad_())
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
