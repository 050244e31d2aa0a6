"""Lambda-warmup learning-rate schedules (port of
reface_tpu/core/lr_schedule.py): the reference's LambdaLinearScheduler and
LambdaWarmUpCosineScheduler as step -> multiplier functions, and its LR
scaling rule."""

from __future__ import annotations

import math

__all__ = ["lambda_linear", "lambda_warmup_cosine", "scale_lr"]


def lambda_linear(warm_up_steps: int = 10_000, f_start: float = 1e-6,
                  f_max: float = 1.0, f_min: float = 1.0,
                  cycle_length: float = 1e13):
    """Linear warmup f_start -> f_max, then linear decay toward f_min over
    the (effectively infinite) cycle: flat at f_max for the shipped config."""

    def schedule(step) -> float:
        step = float(step)
        if step < warm_up_steps:
            return f_start + (f_max - f_start) * step / max(warm_up_steps, 1)
        return f_min + (f_max - f_min) * (cycle_length - step) / cycle_length

    return schedule


def lambda_warmup_cosine(warm_up_steps: int, lr_start: float, lr_max: float,
                         lr_min: float, max_decay_steps: int):
    def schedule(step) -> float:
        step = float(step)
        if step < warm_up_steps:
            return lr_start + (lr_max - lr_start) * step / max(warm_up_steps, 1)
        t = (step - warm_up_steps) / max(max_decay_steps - warm_up_steps, 1)
        t = min(max(t, 0.0), 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))

    return schedule


def scale_lr(base_lr: float, batch_size: int, n_devices: int,
             accumulate: int = 1, n_nodes: int = 1) -> float:
    """The reference's LR scaling rule (main.py:719-723):
    lr = accumulate * nodes * devices * batch * base_lr."""
    return accumulate * n_nodes * n_devices * batch_size * base_lr
