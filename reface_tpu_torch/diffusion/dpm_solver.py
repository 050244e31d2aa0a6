"""DPM-Solver++(2M) sampler (port of reface_tpu/diffusion/dpm_solver.py),
NCHW latents.

A second-order multistep solver of the probability-flow ODE that eta=0
DDIM solves to first order, in the data-prediction (x0) parameterisation
(Lu et al. 2022, arXiv:2211.01095, Algorithm 2). With half-log-SNR
lam = 0.5*log(a/(1-a)), a = alpha_cumprod, alpha = sqrt(a), sigma =
sqrt(1-a), stepping a_t -> a_tgt:

    h   = lam(a_tgt) - lam(a_t)
    x0  = (x - sigma_t * eps) / alpha_t
    D   = x0                                           (order 1)
        = (1 + 1/(2r)) x0 - (1/(2r)) x0_prev,  r = h_prev / h
    x'  = (sigma_tgt / sigma_t) * x - alpha_tgt * expm1(-h) * D

Order 1 on step 0 (no history yet) and, with lower_order_final, on the
last step. All in fp32. The JAX package's two lax.scans (the CFG head and
the conditional-only tail of cfg_steps) are one Python loop here; the
per-step scalars are 0-d device tensors taken from the tables.
"""

from __future__ import annotations

from typing import Optional

import torch

from reface_tpu_torch.core.schedules import DDIMTables
from reface_tpu_torch.diffusion.ddim import ModelFn, cfg_eps

__all__ = ["dpm_solver_sample"]


def _half_log_snr(a: torch.Tensor) -> torch.Tensor:
    """lam = log(alpha/sigma) = 0.5*(log a - log(1-a)) for a = alphacum."""
    return 0.5 * (torch.log(a) - torch.log1p(-a))


def dpm_solver_sample(
    model_fn: ModelFn,
    x_T: torch.Tensor,
    context: torch.Tensor,
    uncond_context: Optional[torch.Tensor],
    inpaint_latent: torch.Tensor,
    mask_latent: torch.Tensor,
    tables: DDIMTables,
    cfg_scale: float = 3.0,
    cfg_steps: Optional[int] = None,
    dedup_model_fn: Optional[ModelFn] = None,
    lower_order_final: Optional[bool] = None,
) -> torch.Tensor:
    """Run the reverse DPM-Solver++(2M) chain; returns the final 4-ch latent.

    Drop-in for ddim_sample (the same 9-ch concat, uncond-first CFG batch
    doubling, cfg_steps interval and prefix-dedup hook; deterministic).
    lower_order_final: order 1 on the last step; None = auto, on when
    num_steps < 15.
    """
    use_cfg = uncond_context is not None and cfg_scale != 1.0
    b = x_T.shape[0]
    dev = x_T.device
    ctx = torch.cat([uncond_context, context]) if use_cfg else context
    rest = torch.cat([inpaint_latent, mask_latent], dim=1)
    n_steps = tables.num_steps
    if lower_order_final is None:
        lower_order_final = n_steps < 15
    n_cfg = n_steps
    if use_cfg and cfg_steps is not None:
        n_cfg = max(0, min(int(cfg_steps), n_steps))

    ts = tables.timesteps.flip(0).tolist()
    a_ts, a_tgts = (a.flip(0).to(dev) for a in (tables.alphas, tables.alphas_prev))
    # h_prev = 1 is a dummy: step 0 is order 1 before h_prev is ever real
    x, x0_prev = x_T, torch.zeros_like(x_T)
    h_prev = torch.tensor(1.0, dtype=x_T.dtype, device=dev)
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
        a_t, a_tgt = a_ts[i], a_tgts[i]
        alpha_t, sigma_t = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
        x0 = (x - sigma_t * eps) / alpha_t
        h = _half_log_snr(a_tgt) - _half_log_snr(a_t)
        if i == 0 or (lower_order_final and i == n_steps - 1):
            d = x0
        else:
            r = h_prev / h
            d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev
        alpha_tgt, sigma_tgt = torch.sqrt(a_tgt), torch.sqrt(1.0 - a_tgt)
        x = (sigma_tgt / sigma_t) * x - alpha_tgt * torch.expm1(-h) * d
        x0_prev, h_prev = x0, h
    return x
