"""Face alignment and paste-back as batched warps (port of
reface_tpu/preprocess/align.py).

The JAX package writes each function for one image and vmaps it; here each
takes a leading batch dimension. Images are NCHW, landmarks (B, 68, 2) and
quads (B, 4, 2) in (x, y) pixel coordinates.

- `compute_align_quad`: the FFHQ oriented crop quad from 68 landmarks.
- `quad_crop`: the bilinear quad warp to size x size (PIL QUAD semantics).
- `calc_perspective_coeffs`, `perspective_warp`, `paste_back`: the 8-param
  homography from the quad to the crop's corners, the warp of the crop back
  onto the frame and the blend by the warped validity (and an optional
  crop-space mask).

`bilinear_sample` clamps each of the four neighbours to the image on its
own, with the weights taken from the unclamped floor, as the JAX function
does; every other step follows the JAX expressions in the same order, so
that the fp32 results agree. The homography is the fp32 normal-equations
solve, through `torch.linalg.solve_ex` (no host sync for a singularity
check).
"""

from __future__ import annotations

import torch

__all__ = [
    "compute_align_quad",
    "quad_crop",
    "calc_perspective_coeffs",
    "perspective_warp",
    "paste_back",
    "bilinear_sample",
]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def _flip(v: torch.Tensor) -> torch.Tensor:
    """(x, y) -> (-y, x): v[::-1] * [-1, 1]."""
    return torch.stack([-v[..., 1], v[..., 0]], -1)


def compute_align_quad(lm: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """(B, 68, 2) landmarks -> (B, 4, 2) oriented crop quads, FFHQ semantics:
    rows [c-x-y, c-x+y, c+x+y, c+x-y] (NW, SW, SE, NE for PIL QUAD)."""
    eye_left = lm[:, 36:42].mean(1)
    eye_right = lm[:, 42:48].mean(1)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[:, 48] + lm[:, 54]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    # x-axis: the eye line, counter-rotated by the mouth direction
    x = eye_to_eye - _flip(eye_to_mouth)
    x = x / _norm(x)
    x = x * torch.maximum(_norm(eye_to_eye) * 2.0, _norm(eye_to_mouth) * 1.8)
    x = x * scale
    y = _flip(x)
    c = eye_avg + eye_to_mouth * 0.1
    return torch.stack([c - x - y, c - x + y, c + x + y, c + x - y], 1)


def bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Sample (B, C, H, W) images at float pixel coordinates xs, ys of shape
    (B, *S): edge-clamped bilinear, (B, C, *S)."""
    b, c, h, w = img.shape
    out_shape = xs.shape[1:]
    xs, ys = xs.reshape(b, -1), ys.reshape(b, -1)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = (xs - x0)[:, None]
    wy = (ys - y0)[:, None]
    flat = img.reshape(b, c, h * w)

    def at(yy, xx):
        yi = yy.clamp(0, h - 1).long()
        xi = xx.clamp(0, w - 1).long()
        idx = (yi * w + xi)[:, None].expand(b, c, -1)
        return torch.gather(flat, 2, idx)

    v00 = at(y0, x0)
    v01 = at(y0, x0 + 1)
    v10 = at(y0 + 1, x0)
    v11 = at(y0 + 1, x0 + 1)
    out = (v00 * (1 - wx) * (1 - wy)
           + v01 * wx * (1 - wy)
           + v10 * (1 - wx) * wy
           + v11 * wx * wy)
    return out.reshape(b, c, *out_shape)


def quad_crop(img: torch.Tensor, quad: torch.Tensor, size: int) -> torch.Tensor:
    """Crop (B, C, H, W) images to size x size by bilinear interpolation of
    each (4, 2) quad (NW, SW, SE, NE): output (u, v) in [0,1]^2 at pixel
    centres maps to the bilinear blend of the corners."""
    u = (torch.arange(size, dtype=torch.float32, device=img.device) + 0.5) / size
    vv, uu = torch.meshgrid(u, u, indexing="ij")  # vv: down, uu: right
    uu, vv = uu[None, ..., None], vv[None, ..., None]
    corner = lambda i: quad[:, i][:, None, None]
    top = corner(0) * (1 - uu) + corner(3) * uu
    bot = corner(1) * (1 - uu) + corner(2) * uu
    pts = top * (1 - vv) + bot * vv  # (B, S, S, 2) x, y
    return bilinear_sample(img, pts[..., 0], pts[..., 1])


def calc_perspective_coeffs(src_pts: torch.Tensor, dst_pts: torch.Tensor) -> torch.Tensor:
    """(B, 8) perspective coefficients mapping output coordinates to source
    coordinates: the least-squares solve of the homography system from four
    (B, 4, 2) point pairs (dst_pts may be one (4, 2) set for the batch)."""
    src = src_pts.float()
    dst = dst_pts.float().expand_as(src)
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    row_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    row_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    a = torch.stack([row_u, row_v], 2).reshape(src.shape[0], 8, 8)
    rhs = dst.reshape(src.shape[0], 8, 1)
    at = a.transpose(1, 2)
    coeffs, _ = torch.linalg.solve_ex(at @ a, at @ rhs)
    return coeffs[..., 0]


def _source_coords(coeffs: torch.Tensor, out_h: int, out_w: int):
    """The source coordinates of every output pixel under the homography:
    ((a x + b y + c) / (g x + h y + 1), (d x + e y + f) / (...)), (B, H, W)."""
    a, b, c, d, e, f, g, h8 = (coeffs[:, i, None, None] for i in range(8))
    ys, xs = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=coeffs.device),
        torch.arange(out_w, dtype=torch.float32, device=coeffs.device),
        indexing="ij")
    denom = g * xs + h8 * ys + 1.0
    return (a * xs + b * ys + c) / denom, (d * xs + e * ys + f) / denom


def perspective_warp(img: torch.Tensor, coeffs: torch.Tensor, out_h: int, out_w: int):
    """Warp (B, C, h, w) images: out(x, y) = img(homography(x, y))."""
    sx, sy = _source_coords(coeffs, out_h, out_w)
    return bilinear_sample(img, sx, sy)


def paste_back(original: torch.Tensor, swapped_crop: torch.Tensor, quad: torch.Tensor,
               crop_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Composite (B, C, S, S) swapped crops back into (B, C, H, W) frames.

    The homography maps frame pixels to crop pixels (the quad's NW corner is
    crop coordinate -0.5, its SE corner S - 0.5, matching quad_crop's pixel
    centres); alpha is 1 where a frame pixel lands inside the crop, times the
    warped (B, 1, S, S) crop_mask when one is given."""
    s = swapped_crop.shape[-1]
    _, _, h, w = original.shape
    corners = torch.tensor(
        [[-0.5, -0.5], [-0.5, s - 0.5], [s - 0.5, s - 0.5], [s - 0.5, -0.5]],
        dtype=torch.float32, device=original.device)
    coeffs = calc_perspective_coeffs(quad, corners)
    sx, sy = _source_coords(coeffs, h, w)
    warped = bilinear_sample(swapped_crop, sx, sy)
    inside = ((sx >= -0.5) & (sx <= s - 0.5) & (sy >= -0.5) & (sy <= s - 0.5))
    alpha = inside.to(original.dtype)[:, None]
    if crop_mask is not None:
        alpha = alpha * bilinear_sample(crop_mask, sx, sy)
    return original * (1 - alpha) + warped * alpha
