"""Synthetic mini dataset trees for tests and smoke runs, written through
io/images.py (port of reface_tpu/data/synthetic.py's CelebA-HQ and FFHQ
trees; its landmark faces wait for the landmark trainer, ROADMAP A13b).

Each item is a uniform-noise image with a 19-class mask of plausible
regions (skin disc, eyes, mouth, hair), drawn from one
np.random.default_rng(seed) in the JAX package's order: the same seed gives
the same pixels and masks in both packages (the JPEG files differ, their
encoders being different).
"""

from __future__ import annotations

import os

import numpy as np

from reface_tpu_torch.io.images import imwrite

__all__ = ["make_synthetic_celeba", "make_synthetic_ffhq", "face_like",
           "CELEBA_CLASS_SUFFIXES", "write_celeba_class_masks"]

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
