"""Synthetic data for tests and smoke runs (port of
reface_tpu/data/synthetic.py): the CelebA-HQ and FFHQ mini trees, written
through io/images.py, and the landmark faces of the landmark trainer.

Each tree item is a uniform-noise image with a 19-class mask of plausible
regions (skin disc, eyes, mouth, hair), drawn from one
np.random.default_rng(seed) in the JAX package's order: the same seed gives
the same pixels and masks in both packages (the JPEG files differ, their
encoders being different). The landmark faces draw from their generator in
the JAX package's order too, so their landmarks and sensor noise are
bit-equal; the shapes are rasterised by data/raster.py's numpy copy of
cv2's LINE_8 rules (the card's machine has no cv2), which leaves a few
pixels at the edges of thick strokes different.
"""

from __future__ import annotations

import os

import numpy as np

from reface_tpu_torch.data import raster
from reface_tpu_torch.io.images import imwrite

__all__ = ["make_synthetic_celeba", "make_synthetic_ffhq", "face_like",
           "CELEBA_CLASS_SUFFIXES", "write_celeba_class_masks",
           "LANDMARK68_TEMPLATE", "make_landmark_faces"]

# CelebAMask-HQ's per-class file suffixes, index = class id - 1
CELEBA_CLASS_SUFFIXES = (
    "skin", "nose", "eye_g", "l_eye", "r_eye", "l_brow", "r_brow", "l_ear",
    "r_ear", "mouth", "u_lip", "l_lip", "hair", "hat", "ear_r", "neck_l",
    "neck", "cloth",
)


def _write(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    imwrite(path, arr)


def face_like(rng: np.random.Generator, size: int):
    """Image with a blob 'face' + a 19-class mask with plausible regions."""
    img = rng.integers(0, 255, (size, size, 3), np.uint8)
    mask = np.zeros((size, size), np.uint8)
    c = size // 2
    r = size // 3
    ys, xs = np.ogrid[:size, :size]
    face = (ys - c) ** 2 + (xs - c) ** 2 < r * r
    mask[face] = 1  # skin
    mask[c - r // 3: c - r // 6, c - r // 2: c - r // 4] = 4  # l_eye
    mask[c - r // 3: c - r // 6, c + r // 4: c + r // 2] = 5  # r_eye
    mask[c + r // 4: c + r // 2, c - r // 4: c + r // 4] = 10  # mouth
    mask[: c - r, :] = 13  # hair above
    return img, mask


def write_celeba_class_masks(root: str, idx: int, mask19: np.ndarray) -> None:
    """CelebAMask-HQ's raw layout of one mask: a 0/255 PNG per class present,
    {root}/CelebA-HQ-mask/{idx // 2000}/{idx:05d}_{suffix}.png (what
    `cli.prepare_data merge-celeba-masks` merges into Overall_mask/)."""
    folder = os.path.join(root, "CelebA-HQ-mask", str(idx // 2000))
    for cls_id, suffix in enumerate(CELEBA_CLASS_SUFFIXES, start=1):
        if (mask19 == cls_id).any():
            _write(os.path.join(folder, f"{idx:05d}_{suffix}.png"),
                   np.where(mask19 == cls_id, 255, 0).astype(np.uint8))


def make_synthetic_celeba(root: str, start: int = 0, count: int = 4,
                          size: int = 64, seed: int = 0,
                          class_masks: bool = False) -> str:
    """A CelebA-HQ tree; class_masks writes the raw per-class masks
    (`write_celeba_class_masks`) instead of the merged Overall_mask/."""
    rng = np.random.default_rng(seed)
    for i in range(start, start + count):
        img, mask = face_like(rng, size)
        _write(os.path.join(root, "CelebA-HQ-img", f"{i}.jpg"), img)
        if class_masks:
            write_celeba_class_masks(root, i, mask)
        else:
            _write(os.path.join(root, "CelebA-HQ-mask", "Overall_mask", f"{i}.png"), mask)
    return root


def make_synthetic_ffhq(root: str, start: int = 0, count: int = 4,
                        size: int = 64, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    for i in range(start, start + count):
        img, mask = face_like(rng, size)
        _write(os.path.join(root, "images512", f"{i:05d}.png"), img)
        _write(os.path.join(root, "BiSeNet_mask", f"{i:05d}.png"), mask)
    return root


def _landmark68_template() -> np.ndarray:
    """Canonical iBUG-68 landmark layout in [0,1]^2 (x right, y down): 17
    jaw points on an ellipse arc, 2x5 brows, 9 nose (4 bridge + 5 base),
    2x6 eyes, 12 outer + 8 inner lip. Both the renderer's skeleton and the
    ground truth of the synthetic landmark faces."""
    pts = []
    # jaw 0-16: lower half-ellipse, left ear -> chin (+y pole) -> right ear
    for i in range(17):
        a = np.pi * (1.0 - i / 16.0)
        pts.append([0.5 + 0.38 * np.cos(a), 0.47 + 0.45 * np.sin(a)])
    # brows 17-21 (left), 22-26 (right): shallow arcs
    for side in (-1, 1):
        cx = 0.5 + side * 0.17
        for i in range(5):
            t = (i / 4.0 - 0.5)
            pts.append([cx + side * t * 0.16, 0.30 - 0.035 * (1 - (2 * t) ** 2)])
    # nose bridge 27-30 + base 31-35
    for i in range(4):
        pts.append([0.5, 0.36 + i * 0.055])
    for i in range(5):
        pts.append([0.5 + (i - 2) * 0.035, 0.555 + 0.012 * (1 - abs(i - 2))])
    # eyes 36-41 (left), 42-47 (right): 6-point ellipses
    for side in (-1, 1):
        cx, cy, rx, ry = 0.5 + side * 0.17, 0.385, 0.055, 0.025
        for i in range(6):
            a = 2 * np.pi * i / 6.0
            pts.append([cx + rx * np.cos(a), cy + ry * np.sin(a)])
    # outer lip 48-59 (12) + inner lip 60-67 (8)
    for n, (rx, ry) in ((12, (0.10, 0.045)), (8, (0.065, 0.02))):
        for i in range(n):
            a = 2 * np.pi * i / n
            pts.append([0.5 + rx * np.cos(a), 0.70 + ry * np.sin(a)])
    return np.asarray(pts, np.float32)


LANDMARK68_TEMPLATE = _landmark68_template()


def make_landmark_faces(n: int, size: int = 256, seed: int = 0,
                        max_rot_deg: float = 15.0,
                        scale_range: tuple = (0.72, 1.05),
                        shift_frac: float = 0.10):
    """n synthetic faces with exact 68-point ground truth: the template under
    a random similarity transform (rotation, scale, translation) with
    per-sample colours, drawn over a textured background (a filled head,
    jaw line, brows, nose, eyes with pupils, lips) and sensor noise.
    Returns (images uint8 (n, size, size, 3), landmarks float32 (n, 68, 2)
    pixel coordinates)."""
    rng = np.random.default_rng(seed)
    images = np.empty((n, size, size, 3), np.uint8)
    landmarks = np.empty((n, 68, 2), np.float32)
    base = LANDMARK68_TEMPLATE - 0.5  # centred for the rotation

    for k in range(n):
        ang = np.deg2rad(rng.uniform(-max_rot_deg, max_rot_deg))
        sc = rng.uniform(*scale_range) * size
        shift = rng.uniform(-shift_frac, shift_frac, 2) * size
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]], np.float32)
        lm = base @ rot.T * sc + size / 2.0 + shift
        landmarks[k] = lm

        img = np.empty((size, size, 3), np.uint8)
        img[:] = rng.integers(20, 235, 3, np.uint8)  # flat background
        for _ in range(6):  # low-frequency background texture
            p = rng.integers(0, size, 4)
            raster.line(img, (int(p[0]), int(p[1])), (int(p[2]), int(p[3])),
                        tuple(int(v) for v in rng.integers(0, 255, 3)),
                        int(rng.integers(1, 6)))
        skin = tuple(int(v) for v in rng.integers(120, 230, 3))
        dark = tuple(int(v) for v in rng.integers(10, 80, 3))
        lip = tuple(int(v) for v in rng.integers(90, 200, 3))

        def poly(idx, color, closed=False, thickness=2, fill=False):
            p = lm[list(idx)].round().astype(np.int32)
            if fill:
                raster.fill_poly(img, p, color)
            else:
                raster.polylines(img, p, closed, color, thickness)

        # head: the jaw arc closed through a forehead arc mirrored from it
        jaw = lm[:17]
        forehead = jaw[::-1] * np.array([1.0, -1.0]) + np.array(
            [0.0, 2.0 * float(jaw[:, 1].min()) - 8.0], np.float32)
        raster.fill_poly(img, np.concatenate([jaw, forehead]).round().astype(np.int32), skin)
        poly(range(17), dark, thickness=2)                    # jaw line
        poly(range(17, 22), dark, thickness=3)                # brows
        poly(range(22, 27), dark, thickness=3)
        poly(range(27, 31), dark, thickness=2)                # nose bridge
        poly(range(31, 36), dark, thickness=2)                # nose base
        poly(range(36, 42), (255, 255, 255), closed=True, fill=True)  # eyes
        poly(range(42, 48), (255, 255, 255), closed=True, fill=True)
        for eye in (range(36, 42), range(42, 48)):            # pupils
            c = lm[list(eye)].mean(0).round().astype(int)
            raster.circle(img, (int(c[0]), int(c[1])), max(2, size // 96), dark)
        poly(range(36, 42), dark, closed=True, thickness=1)
        poly(range(42, 48), dark, closed=True, thickness=1)
        poly(range(48, 60), lip, closed=True, fill=True)      # lips
        poly(range(60, 68), dark, closed=True, thickness=1)
        noise = rng.integers(-12, 13, img.shape, np.int16)    # sensor noise
        images[k] = np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)

    return images, landmarks
