"""Host-side tensor conventions of the input pipeline (the part of
reface_tpu/data/augment.py that the test bench needs): get_tensor's [-1, 1]
and get_tensor_clip's CLIP normalisation (celebA.py:196-229), on HWC
float32 numpy arrays.

The training augmentation of that module, the TPS mask warp
(`tps_warp_mask_np`) and `augment_reference_np`, is not ported yet: it
feeds only the training datasets (ROADMAP A12c).
"""

from __future__ import annotations

import numpy as np

from reface_tpu_torch.nn.arcface import CLIP_MEAN as CLIP_MEAN_NP
from reface_tpu_torch.nn.arcface import CLIP_STD as CLIP_STD_NP

__all__ = ["CLIP_MEAN_NP", "CLIP_STD_NP", "to_tensor_pm1", "clip_normalize_np",
           "clip_unnormalize_np"]


def to_tensor_pm1(img_uint8: np.ndarray) -> np.ndarray:
    """HWC uint8 -> HWC float32 in [-1, 1]."""
    return img_uint8.astype(np.float32) / 127.5 - 1.0


def clip_normalize_np(img01: np.ndarray) -> np.ndarray:
    return (img01 - CLIP_MEAN_NP) / CLIP_STD_NP


def clip_unnormalize_np(img: np.ndarray) -> np.ndarray:
    return img * CLIP_STD_NP + CLIP_MEAN_NP
