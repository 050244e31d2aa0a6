"""The landmark auxiliary head of the full training loss (port of
reface_tpu/nn/landmarks.py:LandmarkAuxHead), NCHW.

Only the head is here: the landmark detectors (LandmarkNet, the ERT) are
another slice (ROADMAP A9).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reface_tpu_torch.nn.layers import Conv2d, Linear

__all__ = ["LandmarkAuxHead"]


class LandmarkAuxHead(nn.Module):
    """UNet decoder features (B, C, h, w) -> (B, 136): conv 3x3 to 128
    channels, ReLU, 2x2 max pool, flatten, linear. At full width C = 640 and
    h = w = 64.

    `fc` reads the NCHW-flattened map; the JAX head flattens NHWC, so its
    kernel's rows are permuted on conversion (ckpt/from_jax.py)."""

    def __init__(self, in_channels: int = 640, size: int = 64, device=None):
        super().__init__()
        self.conv = Conv2d(in_channels, 128, 3, padding=1, device=device)
        self.fc = Linear(128 * (size // 2) ** 2, 136, device=device)

    def forward(self, feats):
        h = F.max_pool2d(F.relu(self.conv(feats.float())), 2, stride=2)
        return self.fc(torch.flatten(h, 1))
