"""DDIM sampler (port of reface_tpu/diffusion/ddim.py), NCHW latents.

Per step: concat [x_t, z_inpaint, mask] -> 9 channels, CFG by batch
doubling with the unconditional half first (or the exact prefix dedup),
eps-parameterised update. The JAX package's 50-step lax.scan is a Python
loop here; the per-step scalars are 0-d device tensors taken from the
tables, so the loop does no host-to-device copy after its start.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from reface_tpu_torch.core.schedules import DDIMTables

__all__ = ["ddim_sample", "ddim_step", "cfg_eps", "stochastic_encode"]

# model_fn(x9: (B,9,H,W), t: (B,) int, context: (B,T,768)) -> eps (B,4,H,W)
ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def cfg_eps(model_fn: ModelFn, x9, t, context_cat, scale: float):
    """Classifier-free-guided eps via batch doubling (uncond first)."""
    b = x9.shape[0]
    eps = model_fn(torch.cat([x9, x9]), torch.cat([t, t]), context_cat)
    e_uncond, e_cond = eps[:b], eps[b:]
    return e_uncond + scale * (e_cond - e_uncond)


def ddim_step(x, eps, a_t, a_prev, sqrt_one_minus_at, sigma_t, noise=None):
    """One DDIM update on the 4-ch latent. Returns (x_prev, pred_x0)."""
    pred_x0 = (x - sqrt_one_minus_at * eps) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t**2, min=0.0)) * eps
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if noise is not None:
        x_prev = x_prev + sigma_t * noise
    return x_prev, pred_x0


def ddim_sample(
    model_fn: ModelFn,
    x_T: torch.Tensor,
    context: torch.Tensor,
    uncond_context: Optional[torch.Tensor],
    inpaint_latent: torch.Tensor,
    mask_latent: torch.Tensor,
    tables: DDIMTables,
    cfg_scale: float = 3.0,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    cfg_steps: Optional[int] = None,
    dedup_model_fn: Optional[ModelFn] = None,
) -> torch.Tensor:
    """Run the full reverse DDIM chain; returns the final 4-ch latent.

    x_T: (B, 4, h, w); context / uncond_context: (B, T, 768);
    inpaint_latent: (B, 4, h, w); mask_latent: (B, 1, h, w).
    cfg_steps: CFG only on the first cfg_steps (high-noise) steps, then the
    conditional forward alone; None = CFG on every step (the reference).
    dedup_model_fn: (x9 at B, t at B, ctx at 2B) -> eps at 2B, the exact CFG
    prefix dedup (UNetModel cfg_expand).
    eta != 0 draws its noise from `generator`.
    """
    use_cfg = uncond_context is not None and cfg_scale != 1.0
    b = x_T.shape[0]
    dev = x_T.device
    ctx = torch.cat([uncond_context, context]) if use_cfg else context
    rest = torch.cat([inpaint_latent, mask_latent], dim=1)
    stochastic = eta != 0.0
    if stochastic and generator is None:
        raise ValueError("eta != 0 requires a torch.Generator")
    n_steps = tables.num_steps
    n_cfg = n_steps
    if use_cfg and cfg_steps is not None:
        n_cfg = max(0, min(int(cfg_steps), n_steps))

    # t: 981 -> 1
    ts = tables.timesteps.flip(0).tolist()
    alphas, alphas_prev, s1m, sigmas = (
        a.flip(0).to(dev) for a in (tables.alphas, tables.alphas_prev,
                                    tables.sqrt_one_minus_alphas, tables.sigmas))
    x = x_T
    for i in range(n_steps):
        x9 = torch.cat([x, rest], dim=1)
        tb = torch.full((b,), ts[i], dtype=torch.int32, device=dev)
        with_cfg = use_cfg and i < n_cfg
        if with_cfg and dedup_model_fn is not None:
            eps2 = dedup_model_fn(x9, tb, ctx)
            e_uncond, e_cond = eps2[:b], eps2[b:]
            eps = e_uncond + cfg_scale * (e_cond - e_uncond)
        elif with_cfg:
            eps = cfg_eps(model_fn, x9, tb, ctx, cfg_scale)
        else:
            eps = model_fn(x9, tb, context)
        noise = None
        if stochastic:
            noise = torch.randn(x.shape, generator=generator, device=dev,
                                dtype=x.dtype)
        x, _ = ddim_step(x, eps, alphas[i], alphas_prev[i], s1m[i], sigmas[i], noise)
    return x


def stochastic_encode(x0: torch.Tensor, t, tables: DDIMTables,
                      generator: torch.Generator | None = None,
                      noise: torch.Tensor | None = None) -> torch.Tensor:
    """Noise x0 to DDIM step index t (the reference's img2img encode,
    ddim.py:572-585, table alphas): sqrt(a_t) x0 + sqrt(1 - a_t) noise.

    t indexes the DDIM subset (0..S-1), not raw DDPM timesteps, one per
    sample or a scalar. The noise is `noise` where given (a test hands in
    the JAX key's draw), else drawn from `generator`.
    """
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    t = torch.as_tensor(t, device=x0.device).long()
    shape = (-1,) + (1,) * (x0.ndim - 1)
    a = torch.sqrt(tables.alphas.to(x0.device))[t].reshape(shape)
    s = tables.sqrt_one_minus_alphas.to(x0.device)[t].reshape(shape)
    return a * x0 + s * noise.to(x0.dtype)
