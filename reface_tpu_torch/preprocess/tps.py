"""Thin-plate-spline warping and grid sampling on the device (port of
reface_tpu/preprocess/tps.py), for the priors of preprocess/priors.py.

U(r) = r^2 log r^2 kernel, the (p+3) L-matrix solve, the [-1,1] grid
convention; `grid_sample_2d` is torch's grid_sampler_2d (bilinear, zeros
padding, align_corners=False), which the JAX function writes out as a
gather-lerp. The training datasets' mask warp is the host TPS of
data/augment.py; `random_tps_mask_warp` is the JAX package's device form of
it (the `decow` augmentation), its draws from a torch.Generator, and
`tps_mask_warp` the same warp from given draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["tps_coefs", "tps_warp", "tps_grid", "grid_sample_2d", "tps_mask_warp",
           "random_tps_mask_warp"]


def _u_kernel(r2: torch.Tensor) -> torch.Tensor:
    """TPS radial kernel U(r) = r^2 log(r^2), with U(0) = 0."""
    small = r2 <= 1e-12
    safe = torch.where(small, torch.ones_like(r2), r2)
    return torch.where(small, torch.zeros_like(r2), safe * torch.log(safe))


def _pairwise_r2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    diff = a[:, None, :] - b[None, :, :]
    return (diff * diff).sum(-1)


def _affine_rows(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones_like(pts[:, :1]), pts], dim=1)


def tps_coefs(x: torch.Tensor, y: torch.Tensor):
    """Solve for the TPS mapping control points x -> y.

    x, y: (p, 2). Returns (w, a): (p, 2) non-affine and (3, 2) affine weights.
    """
    p = x.shape[0]
    k = _u_kernel(_pairwise_r2(x, x))
    pm = _affine_rows(x)  # (p, 3)
    l = torch.cat([torch.cat([k, pm], dim=1),
                   torch.cat([pm.T, x.new_zeros(3, 3)], dim=1)], dim=0)
    rhs = torch.cat([y, y.new_zeros(3, 2)], dim=0)
    q = torch.linalg.solve(l, rhs)
    return q[:p], q[p:]


def tps_warp(x: torch.Tensor, y: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Map pts (m, 2) through the TPS defined by control points x -> y."""
    w, a = tps_coefs(x, y)
    return _affine_rows(pts) @ a + _u_kernel(_pairwise_r2(pts, x)) @ w


def tps_grid(x: torch.Tensor, y: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(H, W, 2) sampling grid in [-1, 1] for grid_sample_2d."""
    gy, gx = torch.meshgrid(
        torch.linspace(-1.0, 1.0, height, device=x.device),
        torch.linspace(-1.0, 1.0, width, device=x.device), indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    return tps_warp(x, y, pts).reshape(height, width, 2)


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample NCHW `img` at `grid` (B, H, W, 2) in [-1, 1], (x, y)
    order: pixel = ((coord + 1) * size - 1) / 2, contributions from outside
    the image are zero. Returns (B, C, H, W)."""
    return F.grid_sample(img, grid.to(img.dtype), mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def tps_mask_warp(mask: torch.Tensor, scale, noise: torch.Tensor) -> torch.Tensor:
    """The draw-free core of random_tps_mask_warp: the interior of a grid_n x
    grid_n control grid over [-1, 1] moved by (noise - 0.5) * scale, noise
    (grid_n - 2, grid_n - 2, 2) in [0, 1) as (x, y), and the NCHW mask
    (B, C, H, W) TPS-warped by it."""
    b, _, h, w = mask.shape
    n = noise.shape[0] + 2
    lin = torch.linspace(-1.0, 1.0, n, device=mask.device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    ctrl = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    full = torch.zeros((n, n, 2), device=mask.device)
    full[1:-1, 1:-1] = (torch.as_tensor(noise, device=mask.device).float() - 0.5) * scale
    grid = tps_grid(ctrl, ctrl + full.reshape(-1, 2), h, w)
    return grid_sample_2d(mask, grid[None].expand(b, h, w, 2))


def random_tps_mask_warp(mask: torch.Tensor, generator: torch.Generator | None = None,
                         scale_range=(0.5, 1.0), grid_n: int = 3) -> torch.Tensor:
    """The `decow` augmentation (reface_tpu/preprocess/tps.py): jitter the
    interior of a grid_n x grid_n control grid and TPS-warp the NCHW mask;
    scale ~ U(scale_range), the noise U[0, 1), both drawn from `generator`
    (a generator on the mask's device)."""
    dev = mask.device
    u = torch.rand((), generator=generator, device=dev)
    scale = scale_range[0] + u * (scale_range[1] - scale_range[0])
    noise = torch.rand((grid_n - 2, grid_n - 2, 2), generator=generator, device=dev)
    return tps_mask_warp(mask, scale, noise)
