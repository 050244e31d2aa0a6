"""PLMS sampler (port of reface_tpu/diffusion/plms.py), NCHW latents.

Adams-Bashforth multistep on eps with the order ramped up over the first
steps:
  step 0: pseudo improved Euler, e' = (e_t + e(x_prev, t_next)) / 2
  step 1: e' = (3 e_t - e_{t-1}) / 2
  step 2: e' = (23 e_t - 16 e_{t-1} + 5 e_{t-2}) / 12
  step 3+: e' = (55 e_t - 59 e_{t-1} + 37 e_{t-2} - 9 e_{t-3}) / 24
then the eta = 0 DDIM update with e'. The JAX package's lax.scan with a
fixed (3, ...) history buffer is a Python loop here, the history a list of
at most three eps tensors, newest first. CFG is batch doubling through
cfg_eps (unconditional half first); like the JAX sampler, PLMS takes no
cfg_steps and no prefix dedup.
"""

from __future__ import annotations

import torch

from reface_tpu_torch.core.schedules import DDIMTables
from reface_tpu_torch.diffusion.ddim import ModelFn, cfg_eps, ddim_step

__all__ = ["plms_sample"]


def plms_sample(
    model_fn: ModelFn,
    x_T: torch.Tensor,
    context: torch.Tensor,
    uncond_context: torch.Tensor | None,
    inpaint_latent: torch.Tensor,
    mask_latent: torch.Tensor,
    tables: DDIMTables,
    cfg_scale: float = 3.0,
) -> torch.Tensor:
    """Run the full reverse PLMS chain (eta=0); returns the final 4-ch latent.

    Shapes as ddim_sample's: x_T (B,4,h,w), contexts (B,T,768), inpaint_latent
    (B,4,h,w), mask_latent (B,1,h,w). One UNet evaluation a step, two on
    step 0.
    """
    use_cfg = uncond_context is not None and cfg_scale != 1.0
    b = x_T.shape[0]
    dev = x_T.device
    ctx = torch.cat([uncond_context, context]) if use_cfg else context
    rest = torch.cat([inpaint_latent, mask_latent], dim=1)

    def eps_at(x, t: int):
        x9 = torch.cat([x, rest], dim=1)
        tb = torch.full((b,), t, dtype=torch.int32, device=dev)
        if use_cfg:
            return cfg_eps(model_fn, x9, tb, ctx, cfg_scale)
        return model_fn(x9, tb, ctx)

    ts = tables.timesteps.flip(0).tolist()
    # t_next of the improved-Euler step: the following (smaller) t; the last
    # step's own t on the last step
    ts_next = ts[1:] + ts[-1:]
    alphas, alphas_prev, s1m = (
        a.flip(0).to(dev) for a in (tables.alphas, tables.alphas_prev,
                                    tables.sqrt_one_minus_alphas))
    x, hist = x_T, []
    for i in range(tables.num_steps):
        step = lambda e: ddim_step(x, e, alphas[i], alphas_prev[i], s1m[i], 0.0)[0]
        e_t = eps_at(x, ts[i])
        if i == 0:
            e_prime = (e_t + eps_at(step(e_t), ts_next[i])) / 2
        elif i == 1:
            e_prime = (3 * e_t - hist[0]) / 2
        elif i == 2:
            e_prime = (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            e_prime = (55 * e_t - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24
        x = step(e_prime)
        hist = [e_t] + hist[:2]
    return x
