"""Diffusion noise schedules and DDIM sampling tables (PyTorch port).

Counterpart of reface_tpu/core/schedules.py. The tables are computed in
float64 numpy exactly as there and stored as float32 tensors; the formulas
are copied, not imported, so this package never loads JAX.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "make_beta_schedule",
    "DiffusionSchedule",
    "DDIMTables",
    "make_ddim_timesteps",
    "timestep_embedding",
]


def make_beta_schedule(
    schedule: str = "linear",
    n_timestep: int = 1000,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Return float64 betas of shape (n_timestep,)."""
    if schedule == "linear":
        betas = (
            np.linspace(
                linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64
            )
            ** 2
        )
    elif schedule == "cosine":
        steps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(steps / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1.0 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0.0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = (
            np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
        )
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return betas


def make_ddim_timesteps(
    num_ddim_steps: int,
    num_ddpm_steps: int = 1000,
    method: str = "uniform",
    alphas_cumprod: "np.ndarray | None" = None,
) -> np.ndarray:
    """DDIM timestep subset, including the reference's +1 offset.

    "uniform"/"quad" are the reference's grids. "lam_uniform" spaces the
    subset uniformly in half-log-SNR lam = 0.5*log(a/(1-a)), the grid the
    DPM-Solver++ error analysis assumes; it needs `alphas_cumprod`.
    """
    if method == "uniform":
        c = num_ddpm_steps // num_ddim_steps
        ts = np.arange(0, num_ddpm_steps, c)
    elif method == "quad":
        ts = (np.linspace(0, math.sqrt(num_ddpm_steps * 0.8), num_ddim_steps) ** 2).astype(int)
    elif method == "lam_uniform":
        return _lam_uniform_timesteps(num_ddim_steps, num_ddpm_steps, alphas_cumprod)
    else:
        raise ValueError(f"unknown ddim discretization {method!r}")
    # +1 so the final step's alpha is the one that scales to data; clipped so
    # non-divisor step counts stay in range
    return np.minimum(ts + 1, num_ddpm_steps - 1)


def _lam_uniform_timesteps(num_ddim_steps: int, num_ddpm_steps: int,
                           alphas_cumprod) -> np.ndarray:
    """Exactly num_ddim_steps distinct indices in [1, T-1], nearest to a grid
    uniform in lam from the "uniform" grid's high-noise anchor down to lam[1]."""
    if alphas_cumprod is None:
        raise ValueError("lam_uniform discretization needs alphas_cumprod")
    acp = np.asarray(alphas_cumprod, np.float64)
    lam = 0.5 * (np.log(acp) - np.log1p(-acp))
    if num_ddim_steps > len(lam) - 1:
        # index 0 is reserved (the +1 offset), so at most T-1 indices exist
        raise ValueError(
            f"lam_uniform needs num_ddim_steps <= {len(lam) - 1}, "
            f"got {num_ddim_steps}"
        )
    t_hi = num_ddpm_steps - num_ddpm_steps // num_ddim_steps + 1
    targets = np.linspace(lam[t_hi], lam[1], num_ddim_steps)
    # greedy nearest-unused index: a plain per-target argmin collapses
    # duplicates where lam is dense against the target spacing
    used = np.zeros(len(lam), bool)
    used[0] = True
    idx = np.empty(num_ddim_steps, np.int64)
    for i, tgt in enumerate(targets):
        d = np.abs(lam - tgt)
        d[used] = np.inf
        j = int(d.argmin())
        idx[i] = j
        used[j] = True
    idx = np.sort(idx)
    if len(np.unique(idx)) != num_ddim_steps:
        raise RuntimeError(
            "lam_uniform produced duplicate timestep indices "
            f"({len(np.unique(idx))} unique of {num_ddim_steps})"
        )
    return idx


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Full-resolution (T-step) DDPM tables, all shape (T,) float32 (on the
    CPU as created)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @staticmethod
    def create(
        schedule: str = "linear",
        timesteps: int = 1000,
        linear_start: float = 0.00085,
        linear_end: float = 0.0120,
        cosine_s: float = 8e-3,
        v_posterior: float = 0.0,
    ) -> "DiffusionSchedule":
        betas = make_beta_schedule(
            schedule, timesteps, linear_start, linear_end, cosine_s
        )
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = (1 - v_posterior) * betas * (1.0 - acp_prev) / (1.0 - acp) + (
            v_posterior * betas
        )
        return DiffusionSchedule(
            betas=_f32(betas),
            alphas_cumprod=_f32(acp),
            alphas_cumprod_prev=_f32(acp_prev),
            sqrt_alphas_cumprod=_f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=_f32(np.sqrt(1.0 - acp)),
            log_one_minus_alphas_cumprod=_f32(np.log(1.0 - acp)),
            sqrt_recip_alphas_cumprod=_f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=_f32(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=_f32(post_var),
            posterior_log_variance_clipped=_f32(
                np.log(np.maximum(post_var, 1e-20))
            ),
            posterior_mean_coef1=_f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=_f32(
                (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)
            ),
        )

    def to(self, device) -> "DiffusionSchedule":
        """The same tables on `device` (q_sample then indexes them there,
        with no copy of t to the host)."""
        return DiffusionSchedule(**{f.name: getattr(self, f.name).to(device)
                                    for f in dataclasses.fields(self)})

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(acp_t) x0 + sqrt(1-acp_t) eps, t: (B,) int."""
        shape = (-1,) + (1,) * (x0.ndim - 1)
        t = t.to(self.betas.device).long()
        a = self.sqrt_alphas_cumprod[t].reshape(shape).to(x0.device, x0.dtype)
        s = self.sqrt_one_minus_alphas_cumprod[t].reshape(shape).to(
            x0.device, x0.dtype)
        return a * x0 + s * noise


@dataclasses.dataclass(frozen=True)
class DDIMTables:
    """Per-DDIM-step tables, all shape (S,), ordered t ascending (CPU)."""

    timesteps: torch.Tensor  # int32 (S,) — DDPM timestep fed to the UNet
    alphas: torch.Tensor  # acp[ts]
    alphas_prev: torch.Tensor  # acp at previous ddim step (acp[0] for the first)
    sqrt_one_minus_alphas: torch.Tensor
    sigmas: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    @staticmethod
    def create(
        schedule: DiffusionSchedule,
        num_steps: int,
        eta: float = 0.0,
        method: str = "uniform",
    ) -> "DDIMTables":
        acp = schedule.alphas_cumprod.cpu().numpy().astype(np.float64)
        ts = make_ddim_timesteps(num_steps, schedule.num_timesteps, method,
                                 alphas_cumprod=acp)
        alphas = acp[ts]
        alphas_prev = np.concatenate([[acp[0]], acp[ts[:-1]]])
        sigmas = eta * np.sqrt(
            (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev)
        )
        return DDIMTables(
            timesteps=torch.as_tensor(ts.astype(np.int32)),
            alphas=_f32(alphas),
            alphas_prev=_f32(alphas_prev),
            sqrt_one_minus_alphas=_f32(np.sqrt(1.0 - alphas)),
            sigmas=_f32(sigmas),
        )


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, (B,) -> (B, dim) float32, cos first."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
