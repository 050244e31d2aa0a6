"""Gradient-guided DDIM sampler (port of reface_tpu/diffusion/ddim_guided.py).

The reference's experimental variant (ldm/models/diffusion/ddim_guided.py:
380-609): at each DDIM step the classifier-free-guided eps, then the
gradient of a guidance loss on the decoded pred_x0 with respect to the
latent x, eps += sqrt(1 - a_t) * scale * grad, and the eta = 0 update.
eps is a constant in the gradient: the UNet runs under no_grad, and
torch.autograd.grad takes the gradient with respect to x alone through
pred_x0 = (x - sqrt(1 - a_t) eps) / sqrt(a_t), the towers' weights frozen.
Where the loss function says it is inactive at t (`active(t)`, the ID
term's gate), its gradient is zero and the step skips the decode and the
backward: eps is left as it is, as JAX adds its exact zero.

The guidance gradient is reproducible run to run: the pools and resizes on
its path are fixed-order products (ops/separable.py), and cuDNN is asked
for deterministic convolution algorithms for this gradient alone
(`deterministic_cudnn`): its default backward-data algorithms for the
BiSeNet and D3DFR towers' convs sum in a varying order on the card.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from reface_tpu_torch.core.schedules import DDIMTables
from reface_tpu_torch.diffusion.ddim import ModelFn, cfg_eps, ddim_step

__all__ = ["guided_ddim_sample", "deterministic_cudnn"]


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic convolution algorithms inside the block only;
    the caller's setting is put back after it."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def guided_ddim_sample(
    model_fn: ModelFn,
    guidance_loss_fn: Callable[[torch.Tensor, int], torch.Tensor],
    x_T: torch.Tensor,
    context: torch.Tensor,
    uncond_context: Optional[torch.Tensor],
    inpaint_latent: torch.Tensor,
    mask_latent: torch.Tensor,
    tables: DDIMTables,
    cfg_scale: float = 3.0,
    guidance_scale: float = 1.0,
    dedup_model_fn: Optional[ModelFn] = None,
) -> torch.Tensor:
    """DDIM chain with a per-step gradient guidance on pred_x0's latent.

    guidance_loss_fn: (pred_x0 latent (B,4,h,w), t int) -> scalar loss; it
    decodes and evaluates its towers itself (diffusion/guidance.py builds
    them). dedup_model_fn: the exact CFG prefix dedup, as ddim_sample takes
    it. guidance_scale 0 takes no gradient. Returns the final 4-ch latent.
    """
    use_cfg = uncond_context is not None and cfg_scale != 1.0
    b = x_T.shape[0]
    dev = x_T.device
    ctx = torch.cat([uncond_context, context]) if use_cfg else context
    rest = torch.cat([inpaint_latent, mask_latent], dim=1)
    active = getattr(guidance_loss_fn, "active", lambda t: True)
    ts = tables.timesteps.flip(0).tolist()  # 981 -> 1
    alphas, alphas_prev, s1m = (a.flip(0).to(dev) for a in (
        tables.alphas, tables.alphas_prev, tables.sqrt_one_minus_alphas))
    x = x_T
    for i, t in enumerate(ts):
        with torch.no_grad():
            x9 = torch.cat([x, rest], dim=1)
            tb = torch.full((b,), t, dtype=torch.int32, device=dev)
            if use_cfg and dedup_model_fn is not None:
                eps2 = dedup_model_fn(x9, tb, ctx)
                eps = eps2[:b] + cfg_scale * (eps2[b:] - eps2[:b])
            elif use_cfg:
                eps = cfg_eps(model_fn, x9, tb, ctx, cfg_scale)
            else:
                eps = model_fn(x9, tb, context)
        if guidance_scale != 0.0 and active(t):
            with torch.enable_grad(), deterministic_cudnn():
                xx = x.detach().requires_grad_(True)
                pred_x0 = (xx - s1m[i] * eps) / torch.sqrt(alphas[i])
                (grad,) = torch.autograd.grad(guidance_loss_fn(pred_x0, t), xx)
            eps = eps + torch.sqrt(1.0 - alphas[i]) * guidance_scale * grad
        with torch.no_grad():
            x, _ = ddim_step(x, eps, alphas[i], alphas_prev[i], s1m[i], 0.0)
    return x
