"""Exponential moving average of parameters (port of reface_tpu/core/ema.py).

The reference's LitEma: shadow copies with the warmup ramp
decay = min(decay, (1 + updates) / (10 + updates)) and the update
shadow += (1 - d) * (param - shadow). The port updates the shadow tensors in
place (the JAX package builds a new tree each step); the state keeps its
counters as Python numbers.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["EmaState", "ema_update"]


@dataclasses.dataclass
class EmaState:
    shadow: dict[str, torch.Tensor]
    decay: float  # the configured max decay
    updates: int  # update counter of the warmup ramp; -1 = no warmup

    @staticmethod
    def create(params: dict[str, torch.Tensor], decay: float = 0.9999,
               warmup: bool = True, dtype=None) -> "EmaState":
        """params: name -> tensor. dtype: the shadow's dtype (None keeps each
        parameter's dtype, LitEma parity; bfloat16 halves the shadow's
        memory at the cost of rounding the average)."""
        shadow = {k: p.detach().to(dtype or p.dtype, copy=True)
                  for k, p in params.items()}
        return EmaState(shadow, float(decay), 0 if warmup else -1)


@torch.no_grad()
def ema_update(state: EmaState, params: dict[str, torch.Tensor]) -> EmaState:
    """One EMA step with the reference's warmup ramp, in place; returns state.

    The math is fp32 (the ramp and 1 - d rounded to fp32, as the JAX
    package computes them) and the result is stored in the shadow's dtype."""
    updates = state.updates + 1 if state.updates >= 0 else state.updates
    d = torch.tensor(state.decay, dtype=torch.float32)
    if updates >= 0:
        ramp = (torch.tensor(1.0 + updates, dtype=torch.float32)
                / torch.tensor(10.0 + updates, dtype=torch.float32))
        d = torch.minimum(d, ramp)
    w = float(1.0 - d)
    for name, s in state.shadow.items():
        s32 = s.float()
        s.copy_(s32 + w * (params[name].detach().float() - s32))
    state.updates = updates
    return state
