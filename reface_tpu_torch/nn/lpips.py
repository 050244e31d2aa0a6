"""LPIPS perceptual distance: AlexNet features + linear calibration (port of
reface_tpu/nn/lpips.py), NCHW.

The 5 post-ReLU feature maps of torchvision's AlexNet.features, each
unit-normalised over channels, squared difference, 1x1 linear calibration,
spatial mean, summed over the taps. Input is [-1,1] RGB, normalised with
LPIPS's shift/scale constants. The full training loss uses it at three
scales (diffusion/losses.py).

State-dict names are those of a full module dump of the reference's LPIPS,
one of the layouts reface_tpu/ckpt/convert.py:convert_lpips reads:
`net.layers.{0,3,6,8,10}.{weight,bias}` (torchvision's AlexNet.features
indices) and `lin.{i}.1.weight`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reface_tpu_torch.nn.layers import Conv2d

__all__ = ["AlexNetFeatures", "LPIPS"]

# LPIPS input scaling constants (from the official implementation)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# (index in torchvision's features, out_ch, kernel, stride, padding, pool_before)
_ALEX = [
    (0, 64, 11, 4, 2, False),
    (3, 192, 5, 1, 2, True),
    (6, 384, 3, 1, 1, True),
    (8, 256, 3, 1, 1, False),
    (10, 256, 3, 1, 1, False),
]


class AlexNetFeatures(nn.Module):
    """Returns the 5 post-ReLU feature maps of torchvision AlexNet.features."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        self.layers = nn.ModuleDict()  # keyed by torchvision's indices
        in_ch = 3
        for idx, ch, k, s, p, _ in _ALEX:
            self.layers[str(idx)] = Conv2d(in_ch, ch, k, stride=s, padding=p,
                                           dtype=dtype, device=device)
            in_ch = ch

    def forward(self, x):
        feats, h = [], x
        for idx, _, _, _, _, pool in _ALEX:
            if pool:
                h = F.max_pool2d(h, 3, stride=2)
            h = F.relu(self.layers[str(idx)](h))
            feats.append(h)
        return feats


def _unit_normalize(f):
    # the reference's normalize_activation: x / (sqrt(sum x^2 + 1e-16) + 1e-10)
    norm = torch.sqrt(torch.sum(f.float() ** 2, dim=1, keepdim=True) + 1e-16)
    return f / (norm + 1e-10)


class LPIPS(nn.Module):
    """lpips(x, y) for NCHW images in [-1,1]; returns (B,) distances."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        self.net = AlexNetFeatures(dtype=dtype, device=device)
        self.lin = nn.ModuleList([
            nn.Sequential(nn.Identity(),  # the reference's Dropout
                          Conv2d(ch, 1, 1, bias=False, device=device))
            for _, ch, *_ in _ALEX])

    def forward(self, x, y):
        r = lambda a: torch.tensor(a, device=x.device).reshape(1, 3, 1, 1)
        shift, scale = r(_SHIFT), r(_SCALE)
        fx, fy = self.net((x - shift) / scale), self.net((y - shift) / scale)
        total = 0.0
        for lin, a, b in zip(self.lin, fx, fy):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            total = total + lin[1](d.float()).mean(dim=(1, 2, 3))
        return total
