from reface_tpu_torch.core.distributions import DiagonalGaussian, normal_kl
from reface_tpu_torch.core.schedules import (
    DDIMTables,
    DiffusionSchedule,
    make_beta_schedule,
    make_ddim_timesteps,
    timestep_embedding,
)

__all__ = [
    "DDIMTables",
    "DiagonalGaussian",
    "DiffusionSchedule",
    "make_beta_schedule",
    "make_ddim_timesteps",
    "normal_kl",
    "timestep_embedding",
]
