"""Segmentation-mask vocabularies, remaps and preserve-list masks (port of
reface_tpu/preprocess/masks.py).

The label tables and LUTs are the JAX package's, copied: the CelebAMask-HQ
19 classes, the face-parsing (BiSeNet) 19-class order, the 9- and 12-class
aggregations, and the shipped preserve lists. `remap`, `preserve_mask` and
`inpaint_mask_from_classes` are LUT takes on a numpy array or a torch tensor
(on the tensor's device).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "CELEBAHQ_LABELS",
    "FACE_PARSING_LABELS",
    "SEG9_LABELS",
    "SEG12_LABELS",
    "CELEBAHQ_TO_SEG12",
    "CELEBAHQ_TO_SEG9",
    "FACE_PARSING_TO_SEG12",
    "remap",
    "preserve_mask",
    "inpaint_mask_from_classes",
    "DEFAULT_PRESERVE_CELEBA",
    "DEFAULT_PRESERVE_CELEBA_SRC_TEST",
    "DEFAULT_PRESERVE_FFHQ_SEG12",
    "HEAD_SWAP_CELEBA",
    "HEAD_SWAP_SEG12",
]

# 19 classes: index 0 = background
CELEBAHQ_LABELS = (
    "background", "skin", "nose", "eye_g", "l_eye", "r_eye", "l_brow",
    "r_brow", "l_ear", "r_ear", "mouth", "u_lip", "l_lip", "hair", "hat",
    "ear_r", "neck_l", "neck", "cloth",
)

# BiSeNet / face-parsing.PyTorch ordering (index 0 = background)
FACE_PARSING_LABELS = (
    "background", "skin", "l_brow", "r_brow", "l_eye", "r_eye", "eye_g",
    "l_ear", "r_ear", "ear_r", "nose", "mouth", "u_lip", "l_lip", "neck",
    "neck_l", "cloth", "hair", "hat",
)

SEG9_LABELS = (
    "background", "mouth", "eyebrows", "eyes", "hair", "nose", "skin",
    "ears", "belowface",
)

SEG12_LABELS = (
    "background", "lip", "eyebrows", "eyes", "hair", "nose", "skin", "ears",
    "belowface", "mouth", "eye_glass", "ear_rings",
)

_SEG12 = {name: i for i, name in enumerate(SEG12_LABELS)}
_SEG9 = {name: i for i, name in enumerate(SEG9_LABELS)}

# source-class name -> seg12 class name (unlisted -> background)
_TO_SEG12_BY_NAME = {
    "skin": "skin", "nose": "nose", "eye_g": "eye_glass",
    "l_eye": "eyes", "r_eye": "eyes", "l_brow": "eyebrows",
    "r_brow": "eyebrows", "l_ear": "ears", "r_ear": "ears",
    "mouth": "mouth", "u_lip": "lip", "l_lip": "lip", "hair": "hair",
    "ear_r": "ear_rings", "neck": "belowface",
}
_TO_SEG9_BY_NAME = {
    "skin": "skin", "nose": "nose",
    "l_eye": "eyes", "r_eye": "eyes", "l_brow": "eyebrows",
    "r_brow": "eyebrows", "l_ear": "ears", "r_ear": "ears",
    "mouth": "mouth", "u_lip": "mouth", "l_lip": "mouth", "hair": "hair",
    "neck": "belowface",
}


def _lut(src_labels, mapping, dst_index) -> np.ndarray:
    out = np.zeros(len(src_labels), np.int32)
    for i, name in enumerate(src_labels):
        if name in mapping:
            out[i] = dst_index[mapping[name]]
    return out


CELEBAHQ_TO_SEG12 = _lut(CELEBAHQ_LABELS, _TO_SEG12_BY_NAME, _SEG12)
CELEBAHQ_TO_SEG9 = _lut(
    CELEBAHQ_LABELS,
    {**_TO_SEG9_BY_NAME, "mouth": "mouth"},
    {**_SEG9, "mouth": 1},
)
FACE_PARSING_TO_SEG12 = _lut(FACE_PARSING_LABELS, _TO_SEG12_BY_NAME, _SEG12)

# Shipped preserve lists (CelebA 19-class ids / FFHQ seg12 ids)
DEFAULT_PRESERVE_CELEBA = (1, 2, 4, 5, 8, 9, 6, 7, 10, 11, 12, 17)
DEFAULT_PRESERVE_CELEBA_SRC_TEST = (1, 2, 4, 5, 8, 9, 6, 7, 10, 11, 12, 13, 17)
DEFAULT_PRESERVE_FFHQ_SEG12 = (1, 2, 3, 5, 6, 7, 9)

# "Universal head swap": the preserve lists extended with hair, hat and
# accessory classes.
HEAD_SWAP_CELEBA = DEFAULT_PRESERVE_CELEBA + (13, 14)  # + hair, hat
HEAD_SWAP_SEG12 = DEFAULT_PRESERVE_FFHQ_SEG12 + (4, 10, 11)  # + hair, glasses, earrings


def remap(mask, lut):
    """Apply a class LUT to an integer mask (any shape, numpy or torch)."""
    if isinstance(mask, np.ndarray):
        return np.take(np.asarray(lut), mask.astype(np.int32))
    return torch.as_tensor(np.asarray(lut), device=mask.device)[mask.long()]


def preserve_mask(mask, classes):
    """Binary float32 mask: 1 where mask's class is in `classes`."""
    n = int(mask.max()) + 1 if isinstance(mask, np.ndarray) else 32
    n = max(n, (max(classes) + 1) if len(classes) else 1, 32)
    lut = np.zeros(n, np.float32)
    for c in classes:
        lut[c] = 1.0
    if isinstance(mask, np.ndarray):
        return np.take(lut, mask.astype(np.int64))
    return torch.as_tensor(lut, device=mask.device)[mask.long()]


def inpaint_mask_from_classes(mask, remove_classes):
    """Reference convention: 1 keeps a pixel, 0 marks the region to inpaint.
    Pixels of the listed face classes become the inpaint region (0),
    everything else is kept (1)."""
    return 1.0 - preserve_mask(mask, remove_classes)
