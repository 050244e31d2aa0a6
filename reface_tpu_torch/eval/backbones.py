"""Eval-model backbones (port of reface_tpu/eval/backbones.py), NCHW:
torchvision's ResNet-50, Hopenet and the Deep3DFaceRecon coefficient net.

Module names are torchvision's (`conv1`, `bn1`, `layer{1-4}.{i}.conv{1-3}`,
`layer{1-4}.{i}.downsample.0/1`) and the reference heads' (`fc_yaw`,
`fc_pitch`, `fc_roll`; D3DFR's seven 1x1 convs `final_layers.0-6`), so the
reference's files load as they are (ckpt/from_torch.py). BatchNorm is frozen
(nn/arcface.py's BatchNormInference, fp32). The JAX package folds D3DFR's
seven heads into one Dense `fc` (reface_tpu/ckpt/convert.py:663-690); the
port keeps them, and ckpt/from_jax.py splits that Dense back.

  - Hopenet: ResNet-50 trunk + three 66-bin heads; angles by expectation,
    sum(softmax(logits) * idx) * 3 - 99 degrees.
  - FaceReconCoeffNet: ResNet-50 -> 257 BFM coefficients (id 80, exp 64,
    tex 80, angle 3, gamma 27, translation 2 + 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reface_tpu_torch.nn.arcface import BatchNormInference
from reface_tpu_torch.nn.layers import Conv2d, Linear

__all__ = ["Bottleneck", "ResNet50", "Hopenet", "FaceReconCoeffNet",
           "decode_hopenet_angles", "D3DFR_HEADS"]

# D3DFR's coefficient heads in order (networks.py:83-91): id, exp, tex,
# angle, gamma, txy, tz
D3DFR_HEADS = (80, 64, 80, 3, 27, 2, 1)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1, dtype=torch.float32,
                 device=None):
        super().__init__()
        out_ch = planes * 4
        kw = dict(bias=False, dtype=dtype, device=device)
        self.conv1 = Conv2d(in_ch, planes, 1, **kw)
        self.bn1 = BatchNormInference(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, **kw)
        self.bn2 = BatchNormInference(planes, device=device)
        self.conv3 = Conv2d(planes, out_ch, 1, **kw)
        self.bn3 = BatchNormInference(out_ch, device=device)
        self.downsample = None
        if in_ch != out_ch or stride != 1:
            self.downsample = nn.Sequential(Conv2d(in_ch, out_ch, 1, stride=stride, **kw),
                                            BatchNormInference(out_ch, device=device))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + h)


class ResNet50(nn.Module):
    """(B, 3, H, W) -> pooled (B, 2048) fp32 features. layers = (3, 4, 6, 3)."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype,
                            device=device)
        self.bn1 = BatchNormInference(64, device=device)
        in_ch = 64
        for li, (planes, blocks, stride) in enumerate(
                [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(in_ch, planes, stride if b == 0 else 1, dtype, device))
                in_ch = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))

    def features(self, x):
        h = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        return h.float().mean(dim=(2, 3))

    def forward(self, x):
        return self.features(x)


class Hopenet(ResNet50):
    """(B, 3, 224, 224) ImageNet-normalized -> (yaw, pitch, roll) logits,
    each (B, num_bins) fp32."""

    def __init__(self, num_bins: int = 66, dtype=torch.float32, device=None):
        super().__init__(dtype, device)
        self.fc_yaw = Linear(2048, num_bins, device=device)
        self.fc_pitch = Linear(2048, num_bins, device=device)
        self.fc_roll = Linear(2048, num_bins, device=device)

    def forward(self, x):
        f = self.features(x)
        return self.fc_yaw(f), self.fc_pitch(f), self.fc_roll(f)


def decode_hopenet_angles(logits: torch.Tensor) -> torch.Tensor:
    """66-bin logits -> degrees by expectation: sum(p * i) * 3 - 99."""
    p = torch.softmax(logits.float(), dim=-1)
    idx = torch.arange(p.shape[-1], dtype=torch.float32, device=p.device)
    return (p * idx).sum(dim=-1) * 3.0 - 99.0


class FaceReconCoeffNet(ResNet50):
    """(B, 3, H, W) in [0, 1] -> (B, 257) BFM coefficients, the seven heads
    concatenated (facerecon_model.py:136-146)."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__(dtype, device)
        self.final_layers = nn.ModuleList(
            [Conv2d(2048, n, 1, device=device) for n in D3DFR_HEADS])

    def forward(self, x):
        f = self.features(x)[:, :, None, None]
        return torch.cat([head(f).flatten(1) for head in self.final_layers], dim=1)

    @staticmethod
    def split_coeffs(coeffs: torch.Tensor) -> dict:
        return {
            "id": coeffs[:, :80],
            "exp": coeffs[:, 80:144],
            "tex": coeffs[:, 144:224],
            "angle": coeffs[:, 224:227],
            "gamma": coeffs[:, 227:254],
            "trans": coeffs[:, 254:257],
        }
