"""The VAE first-stage training loss and step: LPIPS + KL + PatchGAN (port of
reface_tpu/diffusion/vae_loss.py), NCHW.

The reference's LPIPSWithDiscriminator (ldm/modules/losses/
contperceptual.py) and AutoencoderKL's two-optimizer alternation
(ldm/models/autoencoder.py:351-418), as the JAX package reproduces them:

- rec = |x - xrec| * pixelloss_weight + perceptual_weight * LPIPS, the (B,)
  LPIPS distance broadcast over every pixel before the sum over elements / B;
- nll = rec / exp(logvar) + logvar with logvar the constant logvar_init (the
  reference's optimizers never hold it);
- the adaptive weight d_weight = |d nll / d w| / (|d g / d w| + 1e-4),
  clipped to [0, 1e4], times disc_weight, w the decoder's conv_out weight:
  both losses re-expressed through that one conv in fp32 on the detached
  penultimate tap (AutoencoderKL.decode(features=True)), computed only from
  `disc_start` on (0 before, where the GAN term's factor is 0 anyway);
- the discriminator (nn/discriminator.py) sees detached reconstructions
  after the generator update, and both updates are Adam(b1 = 0.5, b2 = 0.9)
  at `lr` (pipelines/train.py::AdamW).

One difference on purpose: d_weight is fully detached here. The JAX
package's probe closes over conv_out's bias without stop_gradient
(reface_tpu/diffusion/vae_loss.py:153,157,163), so from disc_start on its
bias gradient carries the derivative of d_weight, which the reference
detaches (contperceptual.py:39). The tests expect that one leaf to differ.

The random draws (the two posterior normals) are inputs of the step, in the
JAX package's layout, so that the tests can hand the port JAX's own draws.
On the card the generator pass encodes through FlashAttention
(AutoencoderKL.encode(for_grad=True)) and decodes with the trainer's
VAEConfig(remat=True); the discriminator pass's encode runs K2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from reface_tpu_torch.nn.discriminator import NLayerDiscriminator, init_discriminator
from reface_tpu_torch.nn.lpips import LPIPS
from reface_tpu_torch.pipelines.train import AdamW

__all__ = ["VAELossConfig", "hinge_d_loss", "vanilla_d_loss", "adopt_weight",
           "generator_loss", "discriminator_loss", "VAETrainState", "make_vae_draws",
           "make_vae_train_step"]


@dataclasses.dataclass(frozen=True)
class VAELossConfig:
    """The knobs of contperceptual.py:8-11, with the reference's defaults."""

    disc_start: int = 50001
    logvar_init: float = 0.0
    kl_weight: float = 1.0
    pixelloss_weight: float = 1.0
    disc_num_layers: int = 3
    disc_in_channels: int = 3
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_loss: str = "hinge"  # "hinge" | "vanilla"

    def __post_init__(self):
        if self.disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss must be hinge|vanilla, got {self.disc_loss}")


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


def adopt_weight(weight: float, global_step: int, threshold: int, value: float = 0.0) -> float:
    return value if global_step < threshold else weight


def _rec_nll(x, xrec, p_dist, cfg: VAELossConfig):
    """The sum over elements / B of the NLL, with LPIPS broadcast per pixel."""
    rec = cfg.pixelloss_weight * torch.abs(x - xrec)
    if cfg.perceptual_weight > 0 and p_dist is not None:
        rec = rec + cfg.perceptual_weight * p_dist.reshape(-1, 1, 1, 1)
    nll = rec / math.exp(cfg.logvar_init) + cfg.logvar_init
    return torch.sum(nll) / x.shape[0]


def _adaptive_weight(feats, conv_out, x, disc, lpips, cfg: VAELossConfig):
    """d_weight from the gradients of the NLL and the GAN term with respect
    to conv_out's weight alone: both re-expressed through that conv in fp32
    on the detached tap, with the bias, the input and every tower detached.
    The result carries no gradient."""
    with torch.enable_grad():
        f = feats.detach().float()
        w = conv_out.weight.detach().float().requires_grad_()
        xr = F.conv2d(f, w, conv_out.bias.detach().float(), padding=1)
        xs = x.detach()
        p = lpips(xs, xr) if cfg.perceptual_weight > 0 else None
        nll_g, = torch.autograd.grad(_rec_nll(xs, xr, p, cfg), w, retain_graph=True)
        gan_g, = torch.autograd.grad(-torch.mean(disc(xr)), w)
    dw = torch.linalg.vector_norm(nll_g) / (torch.linalg.vector_norm(gan_g) + 1e-4)
    return torch.clamp(dw, 0.0, 1e4) * cfg.disc_weight


def generator_loss(vae, disc, lpips, x, eps, global_step: int, cfg: VAELossConfig):
    """The optimizer_idx=0 branch of contperceptual.py:63-93.

    x: (B,3,H,W) in [-1,1]; eps: (B,4,h,w) the posterior's normal draw.
    Returns (loss, metrics); differentiable with respect to the VAE's
    parameters (take the gradient with respect to those alone: the
    discriminator and LPIPS are frozen here, as the reference's opt_ae holds
    neither)."""
    posterior = vae.encode(x, for_grad=True)
    z = posterior.mean + posterior.std * eps
    xrec, feats = vae.decode(z, for_grad=True, features=True)

    p_dist = lpips(x, xrec) if cfg.perceptual_weight > 0 else None
    nll = _rec_nll(x, xrec, p_dist, cfg)
    kl = torch.sum(posterior.kl()) / x.shape[0]

    disc_factor = adopt_weight(cfg.disc_factor, global_step, cfg.disc_start)
    if cfg.disc_factor > 0.0 and global_step >= cfg.disc_start:
        d_weight = _adaptive_weight(feats, vae.decoder.conv_out, x, disc, lpips, cfg)
    else:
        d_weight = torch.zeros((), device=x.device)
    if disc_factor:
        g_loss = -torch.mean(disc(xrec))
        loss = nll + cfg.kl_weight * kl + d_weight * disc_factor * g_loss
    else:  # the GAN term is multiplied by 0: its value only, for the metrics
        with torch.no_grad():
            g_loss = -torch.mean(disc(xrec))
        loss = nll + cfg.kl_weight * kl
    return loss, {"nll_loss": nll.detach(), "kl_loss": kl.detach(),
                  "g_loss": g_loss.detach(), "d_weight": d_weight,
                  "disc_factor": torch.tensor(disc_factor)}


def discriminator_loss(vae, disc, x, eps, global_step: int, cfg: VAELossConfig):
    """The optimizer_idx=1 branch of contperceptual.py:95-111: differentiable
    with respect to the discriminator; the reconstruction is detached (made
    under no_grad, its encode through K2)."""
    with torch.no_grad():
        posterior = vae.encode(x)
        xrec = vae.decode(posterior.mean + posterior.std * eps)
    logits_real = disc(x.detach())
    logits_fake = disc(xrec)
    fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    disc_factor = adopt_weight(cfg.disc_factor, global_step, cfg.disc_start)
    d_loss = disc_factor * fn(logits_real, logits_fake)
    return d_loss, {"disc_loss": d_loss.detach(),
                    "logits_real": torch.mean(logits_real).detach(),
                    "logits_fake": torch.mean(logits_fake).detach()}


@dataclasses.dataclass
class VAETrainState:
    vae: torch.nn.Module  # holds the parameters
    disc: NLayerDiscriminator
    opt_ae: AdamW
    opt_disc: AdamW
    step: int = 0


def make_vae_draws(batch: int, latent: int, device,
                   generator: torch.Generator | None = None) -> dict:
    """One step's draws in the JAX package's layout: the generator pass's and
    the discriminator pass's posterior normals, (B, h, w, 4) each."""
    shape = (batch, latent, latent, 4)
    return {"eps_gen": torch.randn(shape, generator=generator, device=device),
            "eps_disc": torch.randn(shape, generator=generator, device=device)}


def _nchw(x, device):
    return torch.as_tensor(x, device=device).float().permute(0, 3, 1, 2).contiguous()


def make_vae_train_step(vae, cfg: VAELossConfig, lr: float = 4.5e-6,
                        disc: Optional[NLayerDiscriminator] = None,
                        lpips: Optional[LPIPS] = None):
    """Returns (init_state, step_fn, disc, lpips) for the two-optimizer VAE
    fine-tune of `vae` (an AutoencoderKL, ideally with fp32 weights and
    VAEConfig(remat=True)), on its device.

    init_state(seed=0, disc_params=None) -> VAETrainState: the discriminator
      from taming's init (seeded), or from a state dict; Adam(0.5, 0.9) at
      `lr` over each tree.
    step_fn(state, x, draws=None, generator=None, lpips_params=None) ->
      (state, metrics): x (B,H,W,3) in [-1,1] (NHWC, the JAX layout); draws
      from make_vae_draws (made from `generator` when None); lpips_params
      the LPIPS state dict (loaded into the frozen tower when it changes),
      required when cfg.perceptual_weight > 0. One call is the reference's
      whole batch: the generator update, then the discriminator's.
    """
    dev = next(vae.parameters()).device
    disc = disc or NLayerDiscriminator(cfg.disc_in_channels, n_layers=cfg.disc_num_layers,
                                       device=dev)
    lpips = lpips or LPIPS(device=dev)
    lpips.eval().requires_grad_(False)
    factor = 2 ** (len(vae.config.ch_mult) - 1)
    loaded = {"lpips": None}

    def adam(module):
        return AdamW(dict(module.named_parameters()), lr=lr, b1=0.5, b2=0.9)

    def init_state(seed: int = 0, disc_params: dict | None = None) -> VAETrainState:
        if disc_params is None:
            init_discriminator(disc, seed)
        else:
            disc.load_state_dict(disc_params)
        vae.requires_grad_(True)
        disc.requires_grad_(True)
        return VAETrainState(vae, disc, adam(vae), adam(disc))

    def step_fn(state: VAETrainState, x, draws: dict | None = None,
                generator: torch.Generator | None = None, lpips_params: dict | None = None):
        if lpips_params is None and cfg.perceptual_weight > 0:
            raise ValueError(
                "lpips_params required when perceptual_weight > 0; pass "
                "converted LPIPS weights (random features make the "
                "perceptual term meaningless) or set perceptual_weight=0")
        if lpips_params is not None and loaded["lpips"] is not lpips_params:
            lpips.load_state_dict(lpips_params)
            loaded["lpips"] = lpips_params
        x = _nchw(x, dev)
        if draws is None:
            draws = make_vae_draws(x.shape[0], x.shape[-1] // factor, dev, generator)
        eps_g, eps_d = _nchw(draws["eps_gen"], dev), _nchw(draws["eps_disc"], dev)

        vae_params = state.opt_ae.params
        gl, gaux = generator_loss(state.vae, state.disc, lpips, x, eps_g, state.step, cfg)
        state.opt_ae.step(torch.autograd.grad(gl, vae_params, allow_unused=True))

        dl, daux = discriminator_loss(state.vae, state.disc, x, eps_d, state.step, cfg)
        state.opt_disc.step(torch.autograd.grad(dl, state.opt_disc.params,
                                                allow_unused=True))
        state.step += 1
        return state, {"aeloss": gl.detach(), "discloss": dl.detach(), **gaux, **daux}

    return init_state, step_fn, disc, lpips
