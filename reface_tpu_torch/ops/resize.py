"""Bilinear resizes with torch semantics (port of reface_tpu/ops/resize.py).

The JAX package writes the mask resize out as a gather-lerp because
jax.image.resize antialiases; F.interpolate(antialias=False) already has
the half-pixel, no-antialias semantics that file reproduces. The CLIP
target crop goes the other way: jax.image.resize's antialiased shrink is
F.interpolate(antialias=True), and so is every jax.image.resize bilinear
shrink of the raw-image path. jax.image.resize(..., "nearest") samples
source pixel floor((i + 0.5) * in / out), which XLA compiles to
floor((i + 0.5) * s) with the fp32 scale s = in * fl(1 / out);
resize_nearest takes the same indices. torch's "nearest" takes
floor(i * in / out), and its "nearest-exact" rounds in / out once, which
picks another pixel where (i + 0.5) * in / out is near an integer (at
40 -> 98, i = 73). The tests hold each resize to the JAX
function.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear_no_aa", "resize_bilinear_aa", "resize_nearest"]


def resize_bilinear_no_aa(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW bilinear resize, align_corners=False, no antialias, edge clamp."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=False)


def resize_bilinear_aa(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW bilinear resize that antialiases on downsampling, the semantics
    of jax.image.resize(..., "bilinear") used for the CLIP target crop."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=True)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    scale = float(np.float32(n_in) * (np.float32(1.0) / np.float32(n_out)))
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * scale).long()


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW nearest resize that picks jax.image.resize(..., "nearest")'s
    source pixels, at any ratio."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    x = x.index_select(-2, _nearest_index(h, out_h, x.device))
    return x.index_select(-1, _nearest_index(w, out_w, x.device))
