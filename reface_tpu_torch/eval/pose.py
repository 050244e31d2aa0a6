"""Pose error: Hopenet yaw/pitch/roll L2 between target and swap (port of
reface_tpu/eval/pose.py).

The reference's pose_compare.py runs Hopenet (ResNet-50, 66 bins) on
ImageNet-normalized 224 px crops of the target and of the swap, decodes
the angles by expectation and reports the mean L2 over the (yaw, pitch,
roll) triplets.
"""

from __future__ import annotations

import numpy as np
import torch

from reface_tpu_torch.eval.backbones import decode_hopenet_angles
from reface_tpu_torch.eval.fid import batched

__all__ = ["pose_angles", "pose_l2", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _angles(model, x):
    r = lambda a: torch.as_tensor(a, device=x.device).reshape(1, 3, 1, 1)
    logits = model((x - r(IMAGENET_MEAN)) / r(IMAGENET_STD))
    return torch.stack([decode_hopenet_angles(lg) for lg in logits], dim=-1)


def pose_angles(model: torch.nn.Module, images01, batch_size: int = 64) -> np.ndarray:
    """(N, 224, 224, 3) in [0, 1] -> (N, 3) degrees (yaw, pitch, roll),
    through a Hopenet on its device (ImageNet normalisation inside)."""
    return batched(_angles, model, images01, batch_size)


def pose_l2(angles_target: np.ndarray, angles_swap: np.ndarray) -> float:
    """Mean L2 distance over (yaw, pitch, roll) triplets, in degrees."""
    return float(np.linalg.norm(angles_target - angles_swap, axis=1).mean())
