"""Seeded random weights for both sides of a comparison.

`make_state` walks a reference module (gpubench/reference/nets.py) for its
parameter names, shapes and layer kinds, draws every value from one
torch.Generator in one call on the device, and returns a state dict in the
dtypes the measured program stores (`dtypes`). The program loads it; the
reference loads the same tensors widened to fp32. The same seed gives the
same tensors.

Every layer gets non-zero values, the layers REFace zero-initialises too,
so that the output depends on each of them: products N(0, 1/fan_in), biases
N(0, 0.02^2), norm scales 1 + N(0, 0.05^2), norm shifts N(0, 0.05^2),
PReLU slopes 0.25 + N(0, 0.02^2), embeddings N(0, 0.02^2), the null token
N(0, 1); BatchNorm's running statistics are (0, 1).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gpubench.reference import nets

_NORMS = (nets.GroupNorm, nets.LayerNorm, nets.BatchNorm)


def _rule(owner: nn.Module, leaf: str, shape) -> tuple[float, float]:
    """(offset, std) of the values of one tensor."""
    if isinstance(owner, (nets.Linear, nets.Conv2d)):
        if leaf == "weight":
            return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
        return 0.0, 0.02
    if isinstance(owner, _NORMS):
        return (1.0, 0.05) if leaf == "weight" else (0.0, 0.05)
    if isinstance(owner, nets.PReLU):
        return 0.25, 0.02
    if leaf == "learnable_vector":
        return 0.0, 1.0
    return 0.0, 0.02  # embeddings


def make_state(module: nn.Module, seed: int, device, dtypes: dict | None = None) -> dict:
    """name -> tensor for every entry of module.state_dict(), on `device`,
    in dtypes[name] (default float32)."""
    owners = dict(module.named_modules())
    entries = []
    for name, t in module.state_dict().items():
        path, _, leaf = name.rpartition(".")
        entries.append((name, owners[path], leaf, tuple(t.shape), t.dtype))
    drawn = [e for e in entries if not isinstance(e[1], nets.BatchNorm) or e[2] in ("weight", "bias")]
    total = sum(math.prod(e[3]) for e in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    values = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    dtypes = dtypes or {}
    with torch.no_grad():
        for name, owner, leaf, shape, dtype in entries:
            if isinstance(owner, nets.BatchNorm) and leaf not in ("weight", "bias"):
                fill = 1.0 if leaf == "running_var" else 0.0
                out[name] = torch.full(shape, fill, dtype=dtypes.get(name, dtype), device=device)
                continue
            n = math.prod(shape)
            offset, std = _rule(owner, leaf, shape)
            x = values[at:at + n].view(shape) * std + offset
            at += n
            out[name] = x.to(dtypes.get(name, torch.float32))
    return out


def split_towers(state: dict, towers) -> dict:
    """{"unet.x": t, ...} -> {"unet": {"x": t}, ...} for the named towers."""
    out = {t: {} for t in towers}
    for name, v in state.items():
        tower, _, rest = name.partition(".")
        out[tower][rest] = v
    return out
