"""Bilinear resizes with torch semantics (port of reface_tpu/ops/resize.py).

The JAX package writes the mask resize out as a gather-lerp because
jax.image.resize antialiases; F.interpolate(antialias=False) already has
the half-pixel, no-antialias semantics that file reproduces. The CLIP
target crop goes the other way: it is jax.image.resize(..., "bilinear"),
antialiased on a shrink, and so is every jax.image.resize bilinear resize
of the raw-image path and of the guidance towers' inputs.
resize_bilinear_aa builds jax.image.resize's weight matrices (a triangle
kernel widened by the shrink factor, each column normalised) in numpy and
takes two fp32 products with them (ops/separable.py), on every device, so
that its backward under a guided swap sums in a fixed order.
jax.image.resize(..., "nearest") samples
source pixel floor((i + 0.5) * in / out), which XLA compiles to
floor((i + 0.5) * s) with the fp32 scale s = in * fl(1 / out);
resize_nearest takes the same indices. torch's "nearest" takes
floor(i * in / out), and its "nearest-exact" rounds in / out once, which
picks another pixel where (i + 0.5) * in / out is near an integer (at
40 -> 98, i = 73). The tests hold each resize to the JAX
function.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from reface_tpu_torch.ops.separable import separable_resize

__all__ = ["resize_bilinear_no_aa", "resize_bilinear_aa", "resize_nearest",
           "bilinear_aa_matrix"]


def resize_bilinear_no_aa(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW bilinear resize, align_corners=False, no antialias, edge clamp."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=False)


@lru_cache(maxsize=64)
def bilinear_aa_matrix(n: int, m: int) -> np.ndarray:
    """(m, n) fp32 weights of jax.image.resize's "bilinear" n -> m along one
    axis (jax/_src/image/scale.py compute_weight_mat, transposed): the
    triangle kernel at the half-pixel sample points, widened by n / m on a
    shrink, each output's weights normalised to sum 1, and zero for a
    sample outside the input."""
    inv = np.float32(1.0 / (m / n))
    kernel_scale = np.maximum(inv, np.float32(1.0))
    sample = (np.arange(m, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[np.newaxis, :] - np.arange(n, dtype=np.float32)[:, np.newaxis]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n - 0.5)
    return np.ascontiguousarray(np.where(inside[np.newaxis, :], w, 0).T.astype(np.float32))


def resize_bilinear_aa(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW bilinear resize that antialiases on downsampling, the semantics
    of jax.image.resize(..., "bilinear") used for the CLIP target crop: two
    fp32 products with bilinear_aa_matrix, returned in x.dtype."""
    return separable_resize(x, bilinear_aa_matrix, out_h, out_w)


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
