"""The port's VAE first-stage trainer (reface_tpu_torch.diffusion.vae_loss,
nn/discriminator.py) against the JAX package's, on the CPU.

The PatchGAN's forward, the two d-losses and the posterior's kl / nll, the
generator loss's value and every VAE gradient with the discriminator gate
closed and open, the discriminator loss's gradient, and one whole
make_vae_train_step call, with the JAX draws handed to the port. The tiny
VAE is cli/train_vae.py --tiny's (VAEConfig(ch=16, ch_mult=(1, 2),
num_res_blocks=1), fp32) at 64 px; weights are carried across by
reface_tpu_torch.ckpt.from_jax (vae_from_jax, discriminator_from_jax,
lpips_from_jax), gradients compared by name.

R1 (a fault of the JAX reference, not copied): the JAX adaptive weight's
probe closes over the decoder's conv_out bias without stop_gradient, so from
disc_start on its bias gradient carries the derivative of d_weight. The port
detaches d_weight, as the reference does; the gate-open test holds that
leaf to the JAX gradient less that derivative, computed here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_port_helpers import init_jax, one_torch_thread

from reface_tpu.core.distributions import DiagonalGaussian as JGauss
from reface_tpu.diffusion import vae_loss as JL
from reface_tpu.nn.discriminator import NLayerDiscriminator as JDisc
from reface_tpu.nn.lpips import LPIPS as JLPIPS
from reface_tpu.nn.vae import AutoencoderKL as JVAE
from reface_tpu.nn.vae import VAEConfig as JVAEConfig
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.core.distributions import DiagonalGaussian as PGauss
from reface_tpu_torch.diffusion import vae_loss as PL
from reface_tpu_torch.nn.discriminator import NLayerDiscriminator as PDisc
from reface_tpu_torch.nn.lpips import LPIPS as PLPIPS
from reface_tpu_torch.nn.vae import AutoencoderKL as PVAE
from reface_tpu_torch.nn.vae import VAEConfig as PVAEConfig
from reface_tpu_torch.nn.layers import GroupNorm32
from reface_tpu_torch.ops import attention as PA
from reface_tpu_torch.ops import groupnorm as PG

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

B, S, LAT = 2, 64, 32  # batch, image side, latent side of the tiny VAE


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_grads(got: dict, ref: dict, skip=()):
    """Each gradient within 1e-4 relative L2 of the larger of its own norm
    and 1e-3 of the whole gradient's (test_torch_port_train's limits)."""
    total = np.sqrt(sum(np.sum(np.asarray(r, np.float64) ** 2) for r in ref.values()))
    assert set(got) == set(ref)
    for name, g in got.items():
        if name in skip:
            continue
        r = np.asarray(ref[name], np.float64)
        diff = np.linalg.norm(np.asarray(g, np.float64) - r)
        assert diff <= 1e-4 * max(np.linalg.norm(r), 1e-3 * total), name


@pytest.fixture(scope="module")
def setup():
    """JAX params of the tiny VAE, the discriminator (drawn by the JAX init's
    law, its norm scale stored as its offset from 1) and LPIPS; their port
    modules; a batch and one key's draws."""
    jcfg = JVAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1, dtype=jnp.float32)
    x = np.random.default_rng(0).uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    jvae = JVAE(jcfg)
    vae_p = init_jax(jvae, jnp.zeros((1, S, S, 3)), seed=1)
    jdisc = JDisc()
    # the JAX init's law, drawn in numpy (its eager init takes ~10 s here):
    # kernels N(0, 0.02), the norm scale stored as its offset from 1, N(0, 0.02)
    rng = np.random.default_rng(2)
    disc_p = jax.tree_util.tree_map_with_path(
        lambda path, sds: (rng.normal(0.0, 0.02, sds.shape) if path[-1].key in ("kernel", "scale")
                           else np.zeros(sds.shape)).astype(np.float32),
        jax.eval_shape(jdisc.init, jax.random.key(2), jnp.zeros((1, S, S, 3))))
    lp_p = init_jax(JLPIPS(), jnp.zeros((1, S, S, 3)), jnp.zeros((1, S, S, 3)), seed=3)
    pvae = PVAE(PVAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1, dtype=torch.float32),
                device="cpu")
    pvae.load_state_dict(from_jax.vae_from_jax(vae_p))
    pdisc = PDisc(device="cpu")
    pdisc.load_state_dict(from_jax.discriminator_from_jax(disc_p))
    plp = PLPIPS(device="cpu")
    plp.load_state_dict(from_jax.lpips_from_jax(lp_p))
    plp.requires_grad_(False)
    key = jax.random.key(5)
    kg, kd = jax.random.split(key)
    draws = {"eps_gen": np.array(jax.random.normal(kg, (B, LAT, LAT, 4))),
             "eps_disc": np.array(jax.random.normal(kd, (B, LAT, LAT, 4)))}
    return dict(jvae=jvae, vae_p=vae_p, jdisc=jdisc, disc_p=disc_p, jlp=JLPIPS(), lp_p=lp_p,
                pvae=pvae, pdisc=pdisc, plp=plp, x=x, key=key, kg=kg, draws=draws)


def test_discriminator_matches_jax(setup):
    """The PatchGAN under taming's names (convs at main.0, 2, 5, 8, 11, norms
    at 3, 6, 9) from parameters drawn by the JAX init's law: the norm scales
    carried across as 1 plus the stored offset; the logits within 2e-4 (ATOL, fp32) of the JAX
    forward, batch statistics included, and the JAX init's statistics in
    the port's init_discriminator (kernels N(0, 0.02), scales N(1, 0.02))."""
    s = setup
    sd = s["pdisc"].state_dict()
    assert sorted(sd) == sorted(f"main.{i}.{w}" for i in (0, 2, 5, 8, 11, 3, 6, 9)
                                for w in ("weight", "bias") if not (i in (2, 5, 8) and w == "bias"))
    assert abs(float(sd["main.3.weight"].mean()) - 1.0) < 0.02
    want = s["jdisc"].apply(s["disc_p"], jnp.asarray(s["x"]))
    got = s["pdisc"](_nchw(s["x"]))
    assert got.shape == (B, 1, 6, 6) and want.shape == (B, 6, 6, 1)
    np.testing.assert_allclose(got.detach().numpy()[:, 0], np.asarray(want)[..., 0],
                               atol=2e-4, rtol=0)
    from reface_tpu_torch.nn.discriminator import init_discriminator

    fresh = init_discriminator(PDisc(device="cpu"), seed=0).state_dict()
    assert abs(float(fresh["main.0.weight"].std()) - 0.02) < 0.002
    assert abs(float(fresh["main.3.weight"].mean()) - 1.0) < 0.01
    assert not fresh["main.0.bias"].any() and not fresh["main.3.bias"].any()


def test_d_losses_kl_and_nll_match_jax():
    """hinge_d_loss, vanilla_d_loss, DiagonalGaussian.kl (against N(0,1) and
    another Gaussian) and nll: 1e-6 relative (fp32)."""
    rng = np.random.default_rng(4)
    real, fake = (rng.normal(size=(3, 6, 6, 1)).astype(np.float32) for _ in range(2))
    for name in ("hinge_d_loss", "vanilla_d_loss"):
        want = getattr(JL, name)(jnp.asarray(real), jnp.asarray(fake))
        got = getattr(PL, name)(torch.from_numpy(real), torch.from_numpy(fake))
        assert abs(got.item() / float(want) - 1) < 1e-6, name
    m1, m2 = (rng.normal(size=(3, 8, 8, 8)).astype(np.float32) * 3 for _ in range(2))
    j1, j2 = JGauss.from_moments(jnp.asarray(m1)), JGauss.from_moments(jnp.asarray(m2))
    p1, p2 = PGauss.from_moments(_nchw(m1)), PGauss.from_moments(_nchw(m2))
    sample = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    pairs = [(p1.kl(), j1.kl()), (p1.kl(p2), j1.kl(j2)),
             (p1.nll(_nchw(sample)), j1.nll(jnp.asarray(sample)))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    torch.testing.assert_close(p1.var, torch.exp(p1.logvar), atol=0, rtol=0)


@pytest.fixture(scope="module")
def jax_generator(setup):
    """The JAX generator loss's value and VAE gradient at a step before
    disc_start (gate closed) and at one after it (open), one jit."""
    s = setup
    cfg = JL.VAELossConfig(disc_start=1, disc_weight=0.5, kl_weight=1e-6)

    def f(p, step):
        return JL.generator_loss(s["jvae"], p, s["jdisc"], s["disc_p"], s["jlp"], s["lp_p"],
                                 jnp.asarray(s["x"]), s["kg"], step, cfg)

    fn = jax.jit(jax.value_and_grad(f, has_aux=True))
    return {step: fn(s["vae_p"], jnp.int32(step)) for step in (0, 1)}


def _port_generator(setup, step: int):
    s = setup
    cfg = PL.VAELossConfig(disc_start=1, disc_weight=0.5, kl_weight=1e-6)
    vae = s["pvae"]
    params = dict(vae.named_parameters())
    vae.requires_grad_(True)
    loss, aux = PL.generator_loss(vae, s["pdisc"], s["plp"], _nchw(s["x"]),
                                  _nchw(s["draws"]["eps_gen"]), step, cfg)
    grads = torch.autograd.grad(loss, list(params.values()))
    vae.requires_grad_(False)
    return loss, aux, {k: g.numpy() for k, g in zip(params, grads)}


def _ref_grads(jg):
    return {k: v.numpy() for k, v in from_jax.vae_from_jax(jax.tree.map(np.asarray, jg)).items()}


def test_generator_loss_gate_closed_matches_jax(setup, jax_generator):
    """Before disc_start: the loss (LPIPS broadcast per pixel, KL, the GAN
    term at factor 0) within 1e-5 relative and every VAE gradient within the
    limits of _check_grads; d_weight 0 and the metrics equal."""
    (jl, jaux), jg = jax_generator[0]
    loss, aux, grads = _port_generator(setup, 0)
    assert abs(loss.item() / float(jl) - 1) < 1e-5
    for k in ("nll_loss", "kl_loss", "g_loss"):
        assert abs(aux[k].item() / float(jaux[k]) - 1) < 1e-5, k
    assert aux["d_weight"].item() == 0.0 == float(jaux["d_weight"])
    assert aux["disc_factor"].item() == 0.0 == float(jaux["disc_factor"])
    _check_grads(grads, _ref_grads(jg))


def test_generator_loss_gate_open_matches_jax_but_r1(setup, jax_generator):
    """From disc_start on: d_weight (the ratio of the two gradient norms at
    conv_out's weight, clipped, times disc_weight) within 1e-4 relative of
    JAX's and carrying no gradient; the loss within 1e-5 relative; every VAE
    gradient but decoder.conv_out.bias within _check_grads' limits. That
    leaf (R1) is JAX's less g_loss * disc_factor * d(d_weight)/d(bias),
    the derivative the JAX probe leaks, computed here from the port's
    towers with the bias left attached."""
    s = setup
    (jl, jaux), jg = jax_generator[1]
    loss, aux, grads = _port_generator(setup, 1)
    assert not aux["d_weight"].requires_grad and aux["d_weight"].grad_fn is None
    assert float(aux["d_weight"]) > 0
    assert abs(aux["d_weight"].item() / float(jaux["d_weight"]) - 1) < 1e-4
    assert abs(loss.item() / float(jl) - 1) < 1e-5
    ref = _ref_grads(jg)
    bias = "decoder.conv_out.bias"
    _check_grads(grads, ref, skip=(bias,))

    # the leak: d(d_weight)/d(bias) through the probe, in the port's towers
    vae = s["pvae"]
    with torch.no_grad():
        post = vae.encode(_nchw(s["x"]))
        _, feats = vae.decode(post.mean + post.std * _nchw(s["draws"]["eps_gen"]),
                              features=True)
    b = vae.decoder.conv_out.bias.detach().clone().requires_grad_()
    w = vae.decoder.conv_out.weight.detach().clone().requires_grad_()
    x = _nchw(s["x"])
    cfg = PL.VAELossConfig(disc_start=1, disc_weight=0.5, kl_weight=1e-6)
    xr = F.conv2d(feats, w, b, padding=1)
    nll_g, = torch.autograd.grad(PL._rec_nll(x, xr, s["plp"](x, xr), cfg), w, create_graph=True)
    gan_g, = torch.autograd.grad(-s["pdisc"](xr).mean(), w, create_graph=True)
    dw = torch.linalg.vector_norm(nll_g) / (torch.linalg.vector_norm(gan_g) + 1e-4) * 0.5
    leak, = torch.autograd.grad(dw, b)
    leak = leak.numpy() * float(aux["g_loss"]) * float(aux["disc_factor"])
    assert np.linalg.norm(ref[bias] - grads[bias]) > 1e-3 * np.linalg.norm(ref[bias])
    assert _rel(grads[bias] + leak, ref[bias]) <= 1e-4


def test_discriminator_loss_matches_jax(setup):
    """The discriminator pass (the reconstruction detached, the discriminator
    gate open): the loss within 1e-5 relative and every discriminator
    gradient within _check_grads' limits (the gradient tree converted with
    grads=True: the norm scales' offset is not added)."""
    s = setup
    cfg_kw = dict(disc_start=0, disc_loss="vanilla")

    def f(dp):
        return JL.discriminator_loss(s["jvae"], s["vae_p"], s["jdisc"], dp,
                                     jnp.asarray(s["x"]), jax.random.split(s["key"])[1],
                                     0, JL.VAELossConfig(**cfg_kw))

    (jl, jaux), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(s["disc_p"])
    disc = s["pdisc"]
    params = dict(disc.named_parameters())
    loss, aux = PL.discriminator_loss(s["pvae"], disc, _nchw(s["x"]),
                                      _nchw(s["draws"]["eps_disc"]), 0,
                                      PL.VAELossConfig(**cfg_kw))
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(loss.item() / float(jl) - 1) < 1e-5
    for k in ("logits_real", "logits_fake"):
        assert abs(aux[k].item() - float(jaux[k])) < 2e-4, k
    ref = {k: v.numpy() for k, v in
           from_jax.discriminator_from_jax(jax.tree.map(np.asarray, jg), grads=True).items()}
    _check_grads({k: g.numpy() for k, g in zip(params, grads)}, ref)


def test_vae_train_step_matches_jax(setup):
    """One make_vae_train_step call (generator update, then the
    discriminator's, both Adam(0.5, 0.9)) from the same state, the gate open
    (disc_start 0), with the JAX key's draws: the metrics within 1e-5
    relative (2e-4 absolute for the logits' means), and each update (new -
    old) within 1e-4 relative of JAX's plus one fp32 rounding of the weight,
    over every element whose gradient is above the rounding floor (1e-5 of
    its tree's largest; > 99% of the elements). A first Adam step moves a
    weight by about lr * sign(g), so an element whose gradient is 0 in exact
    arithmetic (a bias under a GroupNorm) moves by the sign of its rounding;
    the decoder's conv_out bias moves by JAX's leaked gradient too (R1), and
    is left out. lr 1e-5 (the reference's order, 4.5e-6) keeps what R1's
    different bias does to the discriminator pass's reconstruction under the
    metrics' limit."""
    import optax

    s = setup
    cfg_kw = dict(disc_start=0, kl_weight=1e-6, disc_weight=0.5)
    init_state, step_fn, _, _ = JL.make_vae_train_step(s["jvae"], JL.VAELossConfig(**cfg_kw),
                                                       lr=1e-5, disc=s["jdisc"], lpips=s["jlp"])
    jstate = init_state(s["vae_p"], jax.random.key(9), image_size=S)
    jstate = dataclasses.replace(jstate, disc_params=s["disc_p"],
                                 opt_disc=optax.adam(1e-5, b1=0.5, b2=0.9).init(s["disc_p"]))
    new, jm = step_fn(jstate, jnp.asarray(s["x"]), s["key"], lpips_params=s["lp_p"])

    vae = PVAE(s["pvae"].config, device="cpu")
    vae.load_state_dict(s["pvae"].state_dict())
    p_init, p_step, disc, _ = PL.make_vae_train_step(vae, PL.VAELossConfig(**cfg_kw), lr=1e-5,
                                                     disc=PDisc(device="cpu"),
                                                     lpips=s["plp"])
    state = p_init(disc_params=s["pdisc"].state_dict())
    grads = {}
    for tower, opt in (("vae", state.opt_ae), ("disc", state.opt_disc)):
        def recording(gs, opt=opt, tower=tower, step=opt.step):
            grads.update({f"{tower}.{k}": g for k, g in zip(opt.names, gs)})
            return step(gs)
        opt.step = recording
    before = {f"vae.{k}": v.clone() for k, v in vae.state_dict().items()}
    before.update({f"disc.{k}": v.clone() for k, v in disc.state_dict().items()})
    state, m = p_step(state, s["x"], s["draws"], lpips_params=s["plp"].state_dict())
    assert state.step == 1
    for k in ("aeloss", "discloss", "nll_loss", "kl_loss", "g_loss", "d_weight"):
        assert abs(m[k].item() / float(jm[k]) - 1) < 1e-5, k
    for k in ("logits_real", "logits_fake"):
        assert abs(m[k].item() - float(jm[k])) < 2e-4, k
    after = {f"vae.{k}": v for k, v in vae.state_dict().items()}
    after.update({f"disc.{k}": v for k, v in disc.state_dict().items()})
    ref_new = {f"vae.{k}": v for k, v in from_jax.vae_from_jax(
        jax.tree.map(np.asarray, new.vae_params)).items()}
    ref_new.update({f"disc.{k}": v for k, v in from_jax.discriminator_from_jax(
        jax.tree.map(np.asarray, new.disc_params)).items()})
    floor = {t: 1e-5 * max(float(g.abs().max()) for k, g in grads.items() if k.startswith(t))
             for t in ("vae", "disc")}
    assert floor["disc"] > 0  # the disc gate is open
    checked = 0
    for k in after:
        if k == "vae.decoder.conv_out.bias":
            continue
        live = (grads[k].abs() > floor[k.split(".")[0]]).numpy()
        upd, ref = (after[k] - before[k]).numpy()[live], (ref_new[k] - before[k]).numpy()[live]
        ulp = np.spacing(np.abs(before[k].numpy()[live]))  # the weight's rounding
        assert np.all(np.abs(upd - ref) <= 1e-4 * np.abs(ref) + ulp), k
        checked += live.sum()
    assert checked > 0.9 * sum(v.numel() for v in after.values())


def test_lpips_params_required_and_routes(monkeypatch):
    """step_fn refuses to run without LPIPS weights when perceptual_weight >
    0, with the JAX check's message. The routes (meta tensors that claim to
    be on the card, the wrappers replaced by recorders): the generator
    pass's encode and decode run FlashAttention, the discriminator pass's
    encode K2 and its decode (no gradient) FlashAttention's forward; the
    GroupNorms take K3 in the discriminator pass only."""
    vae = PVAE(PVAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1, dtype=torch.float32),
               device="cpu")
    init_state, step_fn, _, _ = PL.make_vae_train_step(vae, PL.VAELossConfig())
    with pytest.raises(ValueError, match="lpips_params required when perceptual_weight > 0"):
        step_fn(init_state(), np.zeros((1, S, S, 3), np.float32))

    calls, k3 = [], []
    monkeypatch.setattr(PG, "group_norm_silu",
                        lambda x, scale, bias, groups, eps, silu: k3.append(silu) or x)
    monkeypatch.setattr(PA, "wide_attention",
                        lambda q, k, v, scale: calls.append("k2") or q)
    monkeypatch.setattr(PA.FlashAttention, "apply",
                        lambda q, k, v, scale: calls.append("flash") or q)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    cfg = PVAEConfig(ch=8, ch_mult=(1, 2, 4, 64), num_res_blocks=1, dtype=torch.float32,
                     remat=True)
    meta = PVAE(cfg, device="meta")
    img = torch.zeros(2, 3, 256, 256, device="meta")
    post = meta.encode(img, for_grad=True)
    out, feats = meta.decode(post.mean, for_grad=True, features=True)
    assert out.shape == (2, 3, 256, 256) and feats.shape == (2, 8, 256, 256) and not k3
    with torch.no_grad():
        meta.decode(meta.encode(img).mean)
    assert calls == ["flash", "flash", "k2", "flash"]
    assert len(k3) == sum(isinstance(m, GroupNorm32) for m in meta.modules()) and not any(k3)
