"""Exact adaptive average pooling (port of reface_tpu/ops/pooling.py).

Bin i of an n -> m pool averages input[floor(i*n/m) : ceil((i+1)*n/m)],
torch's AdaptiveAvgPool2d. As in the JAX file, the 1-D pool is a constant
(m, n) averaging matrix and the 2-D pool two fp32 products with those
matrices (ops/separable.py), on every device: its backward then has a
fixed summation order, where F.adaptive_avg_pool2d's CUDA backward sums
with atomics. The tests hold it to the JAX function and to
F.adaptive_avg_pool2d.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from reface_tpu_torch.ops.separable import separable_resize

__all__ = ["adaptive_avg_pool_matrix", "adaptive_avg_pool2d"]


@lru_cache(maxsize=64)
def adaptive_avg_pool_matrix(n: int, m: int) -> np.ndarray:
    """(m, n) matrix A with A @ x = adaptive_avg_pool1d(x, m)."""
    a = np.zeros((m, n), np.float32)
    for i in range(m):
        start = (i * n) // m
        end = -(-((i + 1) * n) // m)  # ceil
        a[i, start:end] = 1.0 / (end - start)
    return a


def adaptive_avg_pool2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW adaptive average pool (computed in fp32, returned in x.dtype)."""
    return separable_resize(x, adaptive_avg_pool_matrix, out_h, out_w)
