"""Progressive step-count distillation of the DDIM swap chain (port of
reface_tpu/diffusion/distill.py), NCHW latents.

A student UNet learns to cover `steps_per_call` consecutive eta=0 teacher
DDIM steps in one (Salimans & Ho 2022), and round 0 distils the CFG-combined
teacher eps into a student that runs one conditional forward (guidance
folding, Meng et al. 2023). The student stays eps-parameterised, so serving
it is SwapConfig(ddim_steps=K, cfg_scale=1.0) with its weights.

The target is the closed-form eps* whose single eta=0 DDIM step lands where
the teacher's window ends; the regression is in x0 space with the max(SNR, 1)
weighting. The random draws (the student step index and the noise) are
inputs of the loss (`make_distill_draws` makes them on the card), so that
the tests can hand the port the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from reface_tpu_torch.core.schedules import DDIMTables, DiffusionSchedule
from reface_tpu_torch.diffusion.ddim import ModelFn, cfg_eps, ddim_step

__all__ = ["DistillConfig", "distill_schedule_plan", "distill_eps_target",
           "teacher_window", "make_distill_draws", "make_distill_loss"]


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    teacher_steps: int = 50
    student_steps: int = 25  # per-round target (a divisor of teacher_steps)
    cfg_scale: float = 3.0  # teacher guidance scale (0/1: teacher unguided)
    fold_cfg: bool = True  # the student runs unguided (guidance folding)
    snr_loss_weight: bool = True  # max(SNR, 1) x0-space weighting
    num_timesteps: int = 1000

    @property
    def steps_per_call(self) -> int:
        """Teacher steps covered by one student step."""
        if self.teacher_steps % self.student_steps:
            raise ValueError(
                f"student_steps {self.student_steps} must divide "
                f"teacher_steps {self.teacher_steps} (uniform-stride tables)")
        return self.teacher_steps // self.student_steps


def distill_schedule_plan(start: int = 50, target: int = 10) -> list[int]:
    """Per-round student step counts from `start` down to `target`: each
    round's count divides its teacher's, preferring the gentlest reduction
    whose count the target divides ((50, 10) -> [10], (50, 5) -> [25, 5])."""
    plan = []
    s = start
    while s > target:
        divs = [d for d in range(target, s // 2 + 1) if s % d == 0]
        good = [d for d in divs if d % target == 0]
        if good:
            nxt = max(good)
        elif divs:
            nxt = max(divs)
        else:
            raise ValueError(f"no divisor path from {s} to {target}")
        plan.append(nxt)
        s = nxt
    return plan


def distill_eps_target(x, x_end, a_t, a_tgt):
    """Closed-form eps* whose single eta=0 DDIM step maps x@a_t -> x_end@a_tgt."""
    r = torch.sqrt(a_tgt / a_t)
    denom = torch.sqrt(1.0 - a_tgt) - r * torch.sqrt(1.0 - a_t)
    return (x_end - r * x) / denom


def _per_sample(table: torch.Tensor, idx: torch.Tensor, ndim: int) -> torch.Tensor:
    return table[idx].reshape((-1,) + (1,) * (ndim - 1))


def teacher_window(model_fn: ModelFn, x, rest, j_hi, k: int, tables: DDIMTables,
                   context, uncond_context, cfg_scale: float):
    """k exact teacher DDIM steps (eta = 0) from table index j_hi downward.

    x: (B,4,h,w) latent at level alphas[j_hi]; rest: (B,5,h,w) [z_inpaint,
    mask]; j_hi: (B,) per-sample start indices; tables on x's device. An
    index below 0 is an identity step (a_prev = a_t), so the final window
    runs the same k steps. CFG by batch doubling (cfg_eps, unconditional half
    first) when uncond_context is given and cfg_scale is not 0 or 1."""
    use_cfg = uncond_context is not None and cfg_scale not in (0.0, 1.0)
    ctx = torch.cat([uncond_context, context]) if use_cfg else context
    for s in range(k):
        j = j_hi - s
        jc = torch.clamp(j, min=0)
        t = tables.timesteps[jc]
        a_t = _per_sample(tables.alphas, jc, x.ndim)
        a_prev = _per_sample(tables.alphas_prev, jc, x.ndim)
        s1m = _per_sample(tables.sqrt_one_minus_alphas, jc, x.ndim)
        a_prev = torch.where((j < 0).reshape(a_t.shape), a_t, a_prev)
        x9 = torch.cat([x, rest], dim=1)
        if use_cfg:
            eps = cfg_eps(model_fn, x9, t, ctx, cfg_scale)
        else:
            eps = model_fn(x9, t, context)
        x, _ = ddim_step(x, eps, a_t, a_prev, s1m, 0.0)
    return x


def make_distill_draws(batch: int, latent: int, cfg: DistillConfig, device,
                       generator: torch.Generator | None = None) -> dict:
    """One loss call's draws, in the JAX package's layout: i (B,) the
    student table index, noise (B, h, w, 4)."""
    kw = dict(generator=generator, device=device)
    return {"i": torch.randint(0, cfg.student_steps, (batch,), **kw),
            "noise": torch.randn((batch, latent, latent, 4), **kw)}


def _tables_on(tables: DDIMTables, device) -> DDIMTables:
    return DDIMTables(*(t.to(device) for t in dataclasses.astuple(tables)))


def make_distill_loss(cfg: DistillConfig, schedule: Optional[DiffusionSchedule] = None,
                      device=None):
    """Returns (loss_fn, teacher_tables, student_tables), the tables on
    `device`.

    loss_fn(student_fn, teacher_fn, z0, rest, context, uncond_context, draws)
      -> (loss, metrics); both fns are eps models on the 9-channel input.
      z0: (B,4,h,w) clean latents; rest: (B,5,h,w) [z_inpaint, mask];
      draws: make_distill_draws' dict (or the JAX package's draws). The
      teacher window runs under torch.no_grad(); the loss is differentiable
      with respect to whatever student_fn closes over.
    """
    schedule = schedule or DiffusionSchedule.create(timesteps=cfg.num_timesteps)
    tt = DDIMTables.create(schedule, cfg.teacher_steps)
    ts = DDIMTables.create(schedule, cfg.student_steps)
    k = cfg.steps_per_call
    # uniform stride: the student's index i starts at the teacher's k*i, and
    # its step a_s[i] -> a_prev_s[i] is the teacher's window k*i, ..., k*i-k+1
    assert torch.equal(ts.timesteps, tt.timesteps[::k]), \
        "teacher/student table misalignment"
    if device is not None:
        tt, ts = _tables_on(tt, device), _tables_on(ts, device)

    def loss_fn(student_fn, teacher_fn, z0, rest, context, uncond_context, draws):
        dev = z0.device
        i = torch.as_tensor(draws["i"], device=dev).long()
        noise = torch.as_tensor(draws["noise"], device=dev).float().permute(0, 3, 1, 2)
        a_t = _per_sample(ts.alphas, i, z0.ndim)
        a_tgt = _per_sample(ts.alphas_prev, i, z0.ndim)
        x = torch.sqrt(a_t) * z0 + torch.sqrt(1.0 - a_t) * noise
        with torch.no_grad():
            x_end = teacher_window(teacher_fn, x, rest, i * k, k, tt, context,
                                   uncond_context, cfg.cfg_scale)
        eps_star = distill_eps_target(x, x_end, a_t, a_tgt)

        t = ts.timesteps[i]
        x9 = torch.cat([x, rest], dim=1)
        if cfg.fold_cfg or uncond_context is None:
            eps_s = student_fn(x9, t, context)
        else:
            ctx = torch.cat([uncond_context, context])
            eps_s = cfg_eps(student_fn, x9, t, ctx, cfg.cfg_scale)

        # ||x0_s - x0*||^2 max(SNR, 1) = ||e_s - e*||^2 (1-a)/a max(a/(1-a), 1)
        d2 = torch.mean((eps_s.float() - eps_star) ** 2, dim=(1, 2, 3))
        if cfg.snr_loss_weight:
            a = a_t.reshape(-1)
            w = (1.0 - a) / a * torch.clamp(a / (1.0 - a), min=1.0)
            loss = torch.mean(w * d2)
        else:
            loss = torch.mean(d2)
        return loss, {"distill_loss": loss.detach(), "eps_mse": torch.mean(d2).detach()}

    return loss_fn, tt, ts
