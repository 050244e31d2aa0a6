"""Full REFace training loss: eps-MSE + k-step DDIM reconstruction with ID
and LPIPS losses (port of reface_tpu/diffusion/losses.py), NCHW.

  1. loss_simple: eps-MSE at random t, q_sample on the 4 live channels, the
     9-channel stack re-assembled before the UNet (plus, optionally, the
     landmark auxiliary head on the same forward's decoder features).
  2. reconstruction: q_sample the SAME noise at t_new = T-1; a k=4-step
     differentiable DDIM whose model timesteps follow
     flip(range(1, t_new-1, (t_new-1)//k)[:k]) ([748, 499, 250, 1]) while
     the alpha/sigma scalars come from the standard k-step DDIM tables; no
     CFG.
  3. the reconstruction's conditioning uses the *flipped* batch's reference
     (another source identity), recomputed through the fusion.
  4. collected latents = [initial noisy latent, first-step pred_x0,
     last-step pred_x0], each differentiably decoded.
  5. ID loss: ArcFace cosine (1 - cos) between each decode masked to the
     inpaint region and the flipped reference, averaged over decodes.
  6. LPIPS loss: sum over decodes x scales against the ground-truth target.

The JAX package's lax.scan over the k steps is a Python loop here, and its
rematerialised scan over the decodes a loop of torch.utils.checkpoint calls:
one decode's towers at a time, so that memory is bounded by one decode's
backward.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reface_tpu_torch.core.profiling import span
from reface_tpu_torch.core.schedules import DDIMTables, DiffusionSchedule
from reface_tpu_torch.diffusion.ddim import ddim_step
from reface_tpu_torch.nn.arcface import CLIP_MEAN, CLIP_STD

__all__ = ["ReconLossConfig", "recon_timestep_seq", "ddim_reconstruct",
           "avg_pool_to", "id_cosine_loss", "reface_losses",
           "recon_collect", "recon_tower_losses", "upsample_keep_mask"]


@dataclasses.dataclass(frozen=True)
class ReconLossConfig:
    ddim_steps: int = 4  # Reconstruct_DDIM_steps (configs/train.yaml)
    id_weight: float = 0.3
    lpips_weight: float = 0.1
    landmark_weight: float = 0.0
    lpips_scales: tuple = (1, 2, 4)  # full, /2, /4
    flip_reference: bool = True  # Same_image_reconstruct=False


def recon_timestep_seq(t_new: int, k: int) -> list[int]:
    """flip(range(1, t_new-1, max(1, (t_new-1)//k))[:k])."""
    skip = max(1, (t_new - 1) // k)
    return list(range(1, t_new - 1, skip))[:k][::-1]


def avg_pool_to(x: torch.Tensor, size: int) -> torch.Tensor:
    """Adaptive average pool NCHW to (size, size) for exact-divisor inputs."""
    b, c, h, _ = x.shape
    if h == size:
        return x
    f = h // size
    return x.reshape(b, c, size, f, size, f).mean(dim=(3, 5))


def upsample_keep_mask(keep_mask: torch.Tensor, size: int) -> torch.Tensor:
    """The latent-resolution keep mask (B,1,h,w) at image size: bilinear
    with half-pixel centres, which is what jax.image.resize(..., "bilinear")
    computes when it upsamples."""
    return F.interpolate(keep_mask, size=(size, size), mode="bilinear",
                         align_corners=False)


def id_cosine_loss(embed_fn: Callable, pred_img, ref_img) -> torch.Tensor:
    """mean(1 - cos(f(pred), f(ref) detached)) with l2-normed embeddings."""
    f_pred = embed_fn(pred_img)
    with torch.no_grad():
        f_ref = embed_fn(ref_img)
    return torch.mean(1.0 - torch.sum(f_pred * f_ref, dim=-1))


def ddim_reconstruct(
    unet_fn: Callable,  # (x9, t(B,), cond) -> eps
    x_noisy4: torch.Tensor,  # (B,4,h,w) q_sampled at t_new
    rest: torch.Tensor,  # (B,5,h,w) inpaint latent + mask channels
    cond: torch.Tensor,
    schedule: DiffusionSchedule,
    k: int = 4,
    t_new: int | None = None,
):
    """k-step differentiable DDIM from t_new. Returns [x_noisy4, the first
    step's pred_x0, the last step's pred_x0] and the final sample."""
    if t_new is None:
        t_new = schedule.num_timesteps - 1
    seq = recon_timestep_seq(t_new, k)
    k = len(seq)  # a short t_new yields fewer steps
    tables = DDIMTables.create(schedule, k, eta=0.0)
    dev = x_noisy4.device
    # scalars indexed k-1-i (descending), from the k-step tables
    alphas, alphas_prev, s1m = (
        a.flip(0).to(dev) for a in (tables.alphas, tables.alphas_prev,
                                    tables.sqrt_one_minus_alphas))
    b = x_noisy4.shape[0]
    x, preds = x_noisy4, []
    for i, t in enumerate(seq):
        x9 = torch.cat([x, rest], dim=1)
        eps = unet_fn(x9, torch.full((b,), t, dtype=torch.int32, device=dev), cond)
        x, pred_x0 = ddim_step(x, eps, alphas[i], alphas_prev[i], s1m[i], 0.0)
        preds.append(pred_x0)
    return [x_noisy4, preds[0], preds[-1]], x


def reface_losses(
    *,
    unet_fn: Callable,
    decode_fn: Callable,  # latent (B,4,h,w) -> image (B,3,S,S), differentiable
    embed_id_fn: Callable,  # [-1,1] image -> (B,512) l2-normed ArcFace
    lpips_fn: Callable | None,  # (x, y) -> (B,) distances
    conditioning_fn: Callable,  # (ref_clip224, landmarks) -> (B,1,768)
    # optional landmark aux loss: the eps-MSE forward also returns the
    # decoder features; the head predicts the 136-d landmarks from
    # cat(features[9:11]) and is trained with MSE
    unet_features_fn: Callable | None = None,  # (x9,t,c) -> (eps, features)
    landmark_head_fn: Callable | None = None,  # (B,C,h,w) -> (B,136)
    schedule: DiffusionSchedule,
    cfg: ReconLossConfig,
    z_start9: torch.Tensor,  # (B,9,h,w) latent stack [z, z_inpaint, mask]
    cond: torch.Tensor,  # conditioning used for the eps-MSE forward
    ref_clip224: torch.Tensor,  # (B,3,224,224) CLIP-normalized reference
    gt_image: torch.Tensor,  # (B,3,S,S) in [-1,1]
    landmarks: torch.Tensor | None,
    t: torch.Tensor,  # (B,) int
    noise: torch.Tensor,  # (B,4,h,w), shared by the eps-MSE and the recon
    portion: str = "both",  # "both" | "eps" | "recon"
):
    """Returns (total_loss, metrics dict). `portion` selects which additive
    term of the loss is built: the split-grad step (pipelines/train.py)
    differentiates "recon" and "eps" one after the other and lets their
    gradients accumulate, which is exact because the total is the sum of
    the two over identical inputs."""
    if portion not in ("both", "eps", "recon"):
        raise ValueError(f"unknown loss portion {portion!r}")
    z4, rest = z_start9[:, :4], z_start9[:, 4:]
    metrics = {}
    total = 0.0

    if portion in ("both", "eps"):
        with span("train.eps"):
            x9 = torch.cat([schedule.q_sample(z4, t, noise), rest], dim=1)
            use_lm_head = (cfg.landmark_weight > 0 and unet_features_fn is not None
                           and landmark_head_fn is not None and landmarks is not None)
            if use_lm_head:
                eps_pred, features = unet_features_fn(x9, t, cond)
                # the two 64x64 320-channel decoder taps of the full UNet;
                # clamped for reduced test configs
                i0 = min(9, len(features) - 2)
                lm_pred = landmark_head_fn(torch.cat([features[i0], features[i0 + 1]], dim=1))
                loss_landmark = torch.mean((lm_pred - landmarks) ** 2)
            else:
                eps_pred = unet_fn(x9, t, cond)
            loss_simple = torch.mean((noise - eps_pred) ** 2)
        metrics["loss_simple"] = loss_simple
        total = total + loss_simple
        if use_lm_head:
            metrics["loss_landmark"] = loss_landmark
            total = total + cfg.landmark_weight * loss_landmark

    if portion == "eps" or (cfg.id_weight <= 0 and cfg.lpips_weight <= 0):
        return total, metrics

    pred_latents, ref_flip = recon_collect(
        unet_fn=unet_fn, conditioning_fn=conditioning_fn, schedule=schedule,
        cfg=cfg, z_start9=z_start9, cond=cond, ref_clip224=ref_clip224,
        landmarks=landmarks, t=t, noise=noise)
    recon_total, recon_metrics = recon_tower_losses(
        decode_fn=decode_fn, embed_id_fn=embed_id_fn, lpips_fn=lpips_fn,
        cfg=cfg, pred_latents=pred_latents, ref_flip=ref_flip, rest=rest,
        gt_image=gt_image)
    metrics.update(recon_metrics)
    total = total + recon_total
    metrics["loss"] = total
    return total, metrics


def recon_collect(*, unet_fn, conditioning_fn, schedule: DiffusionSchedule,
                  cfg: ReconLossConfig, z_start9, cond, ref_clip224, landmarks,
                  t, noise):
    """The k-step DDIM reconstruction chain from t_new = T-1 with the SAME
    noise the eps-MSE used. Returns (pred_latents tuple, ref_flip)."""
    with span("train.recon"):
        z4, rest = z_start9[:, :4], z_start9[:, 4:]
        t_new = schedule.num_timesteps - 1
        z_noisy = schedule.q_sample(z4, torch.full_like(t, t_new), noise)
        if cfg.flip_reference:
            ref_flip = ref_clip224.flip(0)
            recon_cond = conditioning_fn(ref_flip, landmarks)
        else:
            ref_flip, recon_cond = ref_clip224, cond
        pred_latents, _ = ddim_reconstruct(unet_fn, z_noisy, rest, recon_cond,
                                           schedule, k=cfg.ddim_steps, t_new=t_new)
    return tuple(pred_latents), ref_flip


def recon_tower_losses(*, decode_fn, embed_id_fn, lpips_fn,
                       cfg: ReconLossConfig, pred_latents, ref_flip, rest,
                       gt_image):
    """Decode the collected latents and apply the ID and LPIPS towers.
    Returns (weighted recon total, metrics). The towers are frozen, so this
    differentiates only with respect to pred_latents."""
    with span("train.towers"):
        metrics = {}
        total = 0.0
        n_dec = len(pred_latents)
        s = gt_image.shape[-1]
        mask_img = 1.0 - upsample_keep_mask(rest[:, -1:], s)  # 1 = inpaint region
        # the reference back to [-1,1] pixel space (un-CLIP-norm, then x2-1)
        r = lambda a: torch.as_tensor(a, device=ref_flip.device).reshape(1, 3, 1, 1)
        ref_pm1 = (ref_flip * r(CLIP_STD) + r(CLIP_MEAN)) * 2.0 - 1.0
        with torch.no_grad():
            f_ref = embed_id_fn(ref_pm1)  # the reference is embedded once

        # scales where AlexNet's stride-4 conv and max pools do not collapse to
        # zero-size maps; the 512 px protocol's scales (512/256/128) all pass
        use_lpips = lpips_fn is not None and cfg.lpips_weight > 0
        scales = [f for f in cfg.lpips_scales if s // f >= 32] if use_lpips else []
        gt_scaled = [avg_pool_to(gt_image, s // f) for f in scales]

        def tower_body(pred):
            dec = decode_fn(pred)  # (B, 3, s, s)
            f_pred = embed_id_fn(dec * mask_img)
            idc = torch.mean(1.0 - torch.sum(f_pred * f_ref, dim=-1))
            lps = [torch.mean(lpips_fn(avg_pool_to(dec, s // f), g))
                   for f, g in zip(scales, gt_scaled)]
            return torch.stack([idc] + lps)

        # one decode's towers at a time, recomputed in the backward: memory is
        # bounded by a single decode's backward
        sums = sum(checkpoint(tower_body, pred, use_reentrant=False)
                   if torch.is_grad_enabled() and pred.requires_grad else tower_body(pred)
                   for pred in pred_latents)
        id_loss = sums[0] / n_dec  # mean over decodes of per-decode means
        metrics["id_loss"] = id_loss
        total = total + cfg.id_weight * id_loss
        if use_lpips:
            lp = torch.sum(sums[1:])  # sum over decodes x scales of means
            metrics["lpips_loss"] = lp
            total = total + cfg.lpips_weight * lp
        return total, metrics
