"""Pools and resizes of NCHW images as two products with constant matrices.

The JAX package pools with two averaging matrices (reface_tpu/ops/
pooling.py) and jax.image.resize contracts each spatial axis with a weight
matrix. The port computes its pools and the resizes that sit under autograd
the same way, y = A_h @ x @ A_w^T, instead of F.adaptive_avg_pool2d and
F.interpolate, whose CUDA backward sums with atomics: the backward here is
two products again, A_h^T @ g @ A_w, so a guided swap's gradient has one
summation order run after run. Both products run in full fp32, TF32 off,
whatever the caller's matmul precision (`ieee_fp32_products`). The matrices
are built once in numpy and kept on each device (`weight_matrix`).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

__all__ = ["weight_matrix", "ieee_fp32_products", "separable_resize"]

_MATRICES: dict = {}


def weight_matrix(build: Callable[[int, int], np.ndarray], n: int, m: int,
                  device) -> torch.Tensor:
    """build(n, m), an (m, n) numpy matrix, as an fp32 tensor on `device`,
    cached per (build, n, m, device)."""
    key = (build, n, m, torch.device(device))
    a = _MATRICES.get(key)
    if a is None:
        a = _MATRICES[key] = torch.from_numpy(build(n, m)).to(device=device,
                                                              dtype=torch.float32)
    return a


@contextlib.contextmanager
def ieee_fp32_products():
    """cuBLAS fp32 products in full fp32 (no TF32) inside the block; the
    caller's setting, legacy and new API alike, is put back after it."""
    mm = torch.backends.cuda.matmul
    legacy = torch.get_float32_matmul_precision()
    new = getattr(mm, "fp32_precision", None)
    if legacy == "highest" and new in (None, "none", "ieee"):
        yield
        return
    torch.set_float32_matmul_precision("highest")
    if new is not None:
        mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(legacy)
        if new is not None:
            mm.fp32_precision = new


def _apply(x, ah, aw):
    if ah is not None:
        x = torch.matmul(ah, x)
    if aw is not None:
        x = torch.matmul(x, aw.t())
    return x


class _Separable(torch.autograd.Function):
    """A_h @ x @ A_w^T and its backward A_h^T @ g @ A_w, each in full fp32
    (a None matrix is the identity)."""

    @staticmethod
    def forward(ctx, x, ah, aw):
        ctx.mats = (ah, aw)
        with ieee_fp32_products():
            return _apply(x, ah, aw)

    @staticmethod
    def backward(ctx, g):
        ah, aw = ctx.mats
        with ieee_fp32_products():
            gx = _apply(g, None if ah is None else ah.t(), None if aw is None else aw.t())
        return gx, None, None


def separable_resize(x: torch.Tensor, build: Callable[[int, int], np.ndarray],
                     out_h: int, out_w: int) -> torch.Tensor:
    """(B, C, H, W) x -> (B, C, out_h, out_w) in x.dtype: A_h @ x @ A_w^T
    computed in fp32, each A = build(size in, size out); an axis whose size
    stays is left as it is, and x itself is returned when both do."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    mat = lambda n, m: None if n == m else weight_matrix(build, n, m, x.device)
    return _Separable.apply(x.float(), mat(h, out_h), mat(w, out_w)).to(x.dtype)
