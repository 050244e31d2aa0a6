"""Host-side augmentation of the input pipeline (port of
reface_tpu/data/augment.py), on HWC float32 numpy arrays, without cv2.

- Tensor conventions: get_tensor's [-1, 1] and get_tensor_clip's CLIP
  normalisation (celebA.py:196-229).
- The decow TPS mask warp (celebA.py:83-95): a 3x3 control grid with its
  interior jittered by U(-0.5, 0.5) * scale, the grid built by
  native_ops.tps_grid, then a bilinear remap with zeros outside (cv2's
  INTER_LINEAR / BORDER_CONSTANT, native_ops.remap_bilinear).
- The reference-image augmentation (celebA.py:349-359): resize to 224, hflip
  p=.5, rotate +-20 deg, box blur p=.3, elastic p=.3, each step what the cv2
  call of the JAX package computes (cv2 5's float remaps: exact bilinear
  weights, no fixed-point taps).

Every random number comes from the caller's np.random.Generator, drawn in the
JAX package's order and count, so an item is the same function of
(seed, index) in both packages.
"""

from __future__ import annotations

import math

import numpy as np

from reface_tpu_torch import native_ops
from reface_tpu_torch.io.images import resize_linear
from reface_tpu_torch.nn.arcface import CLIP_MEAN as CLIP_MEAN_NP
from reface_tpu_torch.nn.arcface import CLIP_STD as CLIP_STD_NP

__all__ = ["CLIP_MEAN_NP", "CLIP_STD_NP", "to_tensor_pm1", "clip_normalize_np",
           "clip_unnormalize_np", "tps_warp_mask_np", "augment_reference_np"]


def to_tensor_pm1(img_uint8: np.ndarray) -> np.ndarray:
    """HWC uint8 -> HWC float32 in [-1, 1]."""
    return img_uint8.astype(np.float32) / 127.5 - 1.0


def clip_normalize_np(img01: np.ndarray) -> np.ndarray:
    return (img01 - CLIP_MEAN_NP) / CLIP_STD_NP


def clip_unnormalize_np(img: np.ndarray) -> np.ndarray:
    return img * CLIP_STD_NP + CLIP_MEAN_NP


# ----------------------------------------------------------- cv2's filters

def _reflect(i: np.ndarray, n: int, delta: int) -> np.ndarray:
    """cv2's borderInterpolate: BORDER_REFLECT (delta 0, abc|cba) or
    BORDER_REFLECT_101 (delta 1, abc|ba), repeated until in range."""
    i = np.asarray(i, np.int64).copy()
    if n == 1:
        return np.zeros_like(i)
    while True:
        low, high = i < 0, i >= n
        if not (low.any() or high.any()):
            return i
        i[low] = -i[low] - 1 + delta
        i[high] = n - 1 - (i[high] - n) - delta


def _remap_reflect(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(src, map_x, map_y, INTER_LINEAR, BORDER_REFLECT) of an
    (H, W[, C]) float32 image: exact bilinear weights, each tap reflected."""
    h, w = src.shape[:2]
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    ax = (map_x - x0).astype(np.float32)
    ay = (map_y - y0).astype(np.float32)
    xs = [_reflect(x0, w, 0), _reflect(x0 + 1, w, 0)]
    ys = [_reflect(y0, h, 0), _reflect(y0 + 1, h, 0)]
    if src.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]
    wx, wy = [1 - ax, ax], [1 - ay, ay]
    out = sum(src[ys[j], xs[i]] * (wx[i] * wy[j]) for j in (0, 1) for i in (0, 1))
    return out.astype(np.float32)


def _correlate_rows(x: np.ndarray, kernel: np.ndarray, axis: int) -> np.ndarray:
    """Centred 1-D correlation along `axis` with BORDER_REFLECT_101 (cv2's
    default filter border), in float64."""
    r = len(kernel) // 2
    n = x.shape[axis]
    idx = _reflect(np.arange(-r, n + r), n, 1)
    padded = np.take(x.astype(np.float64), idx, axis=axis)
    out = np.zeros(x.shape, np.float64)
    for t, c in enumerate(kernel):
        out += c * np.take(padded, np.arange(t, t + n), axis=axis)
    return out


def _box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.blur(img, (k, k)) of a float32 image: the normalised box filter,
    sums in float64 (cv2's sum type for float input), BORDER_REFLECT_101."""
    ones = np.ones(k)
    out = _correlate_rows(_correlate_rows(img, ones, 1), ones, 0)
    return (out * (1.0 / (k * k))).astype(np.float32)


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) of a float32 image: the kernel
    size cv2 derives from sigma (round(8 sigma + 1) | 1), getGaussianKernel's
    taps (computed in float64, stored as float32), BORDER_REFLECT_101."""
    n = int(np.rint(sigma * 4 * 2 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    taps = np.exp(-0.5 / (sigma * sigma) * x * x)
    taps = (taps / taps.sum()).astype(np.float32).astype(np.float64)
    return _correlate_rows(_correlate_rows(img, taps, 1), taps, 0).astype(np.float32)


def _rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """cv2.warpAffine(img, getRotationMatrix2D((s/2, s/2), angle, 1), (s, s),
    INTER_LINEAR) of a square image: zeros outside."""
    s = img.shape[0]
    a = math.radians(angle)
    alpha, beta = math.cos(a), math.sin(a)
    c = s / 2
    fwd = np.array([[alpha, beta, (1 - alpha) * c - beta * c],
                    [-beta, alpha, beta * c + (1 - alpha) * c]], np.float64)
    # warpAffine samples through the inverse (cv2's invertAffineTransform)
    d = 1.0 / (fwd[0, 0] * fwd[1, 1] - fwd[0, 1] * fwd[1, 0])
    a00, a01, a10, a11 = fwd[1, 1] * d, -fwd[0, 1] * d, -fwd[1, 0] * d, fwd[0, 0] * d
    m = np.array([[a00, a01, -a00 * fwd[0, 2] - a01 * fwd[1, 2]],
                  [a10, a11, -a10 * fwd[0, 2] - a11 * fwd[1, 2]]])
    ys, xs = np.mgrid[0:s, 0:s].astype(np.float64)
    map_x = (m[0, 0] * xs + m[0, 1] * ys + m[0, 2]).astype(np.float32)
    map_y = (m[1, 0] * xs + m[1, 1] * ys + m[1, 2]).astype(np.float32)
    return native_ops.remap_bilinear(img, map_x, map_y)


# ------------------------------------------------------------------ TPS

def tps_warp_mask_np(mask: np.ndarray, rng: np.random.Generator,
                     scale: float | None = None, grid_n: int = 3) -> np.ndarray:
    """decow parity: warp an (H, W) or (H, W, 1) mask with a jittered TPS."""
    squeeze = mask.ndim == 2
    m = mask if squeeze else mask[..., 0]
    h, w = m.shape
    if scale is None:
        scale = rng.uniform(0.5, 1.0)
    lin = np.linspace(-1, 1, grid_n)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    ctrl = np.stack([gx.ravel(), gy.ravel()], -1)
    noise = (rng.random((grid_n - 2, grid_n - 2, 2)) - 0.5) * scale
    full = np.zeros((grid_n, grid_n, 2))
    full[1:-1, 1:-1] = noise
    warped = ctrl + full.reshape(-1, 2)
    grid = native_ops.tps_grid(ctrl.astype(np.float32), warped.astype(np.float32), h, w)
    # torch grid_sample's align_corners=False convention
    map_x = ((grid[..., 0] + 1) * w - 1) / 2
    map_y = ((grid[..., 1] + 1) * h - 1) / 2
    out = native_ops.remap_bilinear(m.astype(np.float32)[..., None], map_x, map_y)[..., 0]
    return out if squeeze else out[..., None]


# ------------------------------------------------- reference augmentation

def augment_reference_np(img01: np.ndarray, rng: np.random.Generator, size: int = 224,
                         flip_p: float = 0.5, rot_limit: float = 20.0,
                         blur_p: float = 0.3, elastic_p: float = 0.3) -> np.ndarray:
    """Augment the masked reference crop ([0,1] HWC float32) to size x size."""
    out = resize_linear(np.asarray(img01, np.float32), size, size)
    if rng.random() < flip_p:
        out = out[:, ::-1]
    out = _rotate(out, rng.uniform(-rot_limit, rot_limit))
    if rng.random() < blur_p:
        k = int(rng.integers(1, 4)) * 2 + 1
        out = _box_blur(out, k)
    if rng.random() < elastic_p:
        alpha, sigma = 20.0, 5.0
        dx = _gaussian_blur(rng.random((size, size)).astype(np.float32) * 2 - 1, sigma) * alpha
        dy = _gaussian_blur(rng.random((size, size)).astype(np.float32) * 2 - 1, sigma) * alpha
        xs, ys = np.meshgrid(np.arange(size), np.arange(size))
        out = _remap_reflect(out, (xs + dx).astype(np.float32), (ys + dy).astype(np.float32))
    return np.clip(out, 0.0, 1.0)
