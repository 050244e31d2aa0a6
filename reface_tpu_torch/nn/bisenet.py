"""BiSeNet face parser with a ResNet-18 context path (port of
reface_tpu/nn/bisenet.py), NCHW.

ResNet-18 backbone (feat8/16/32), attention refinement on the 16 and 32
features plus the global context, feature fusion of feat8 with the refined
context (the spatial path is feat8, as in face-parsing.PyTorch), the
19-class head, and the bilinear align_corners=True upsample to the input
size; optionally the two auxiliary heads. BatchNorm is the frozen inference
form in fp32 (nn/arcface.py), each conv computes in the config's dtype, and
the logits come back fp32.

Module names are the face-parsing checkpoint's (`cp.resnet.layer1.0.conv1.
weight`, `cp.arm16.conv.conv.weight`, `ffm.convblk.bn.running_mean`,
`conv_out.conv_out.weight`, ...), the keys reface_tpu/ckpt/convert.py's
BiSeNet rule reads, so 79999_iter.pth loads with load_state_dict alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reface_tpu_torch.nn.arcface import BatchNormInference
from reface_tpu_torch.nn.layers import Conv2d

__all__ = ["BiSeNetConfig", "BiSeNet", "parse_faces", "SEG_MEAN", "SEG_STD",
           "resize_bilinear_align_corners"]

SEG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
SEG_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class BiSeNetConfig:
    n_classes: int = 19
    stem: int = 64
    dtype: torch.dtype = torch.bfloat16


def resize_bilinear_align_corners(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def _conv(cin, cout, ks, stride=1, dt=torch.float32, device=None):
    return Conv2d(cin, cout, ks, stride=stride, padding=ks // 2, bias=False,
                  dtype=dt, device=device)


class ConvBN(nn.Module):
    """conv (no bias) -> BatchNorm -> ReLU (face-parsing's ConvBNReLU)."""

    def __init__(self, cin, cout, ks=3, stride=1, relu=True, dt=torch.float32,
                 device=None):
        super().__init__()
        self.conv = _conv(cin, cout, ks, stride, dt, device)
        self.bn = BatchNormInference(cout, device=device)
        self.relu = relu

    def forward(self, x):
        h = self.bn(self.conv(x))
        return F.relu(h) if self.relu else h


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1, dt=torch.float32, device=None):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, dt, device)
        self.bn1 = BatchNormInference(cout, device=device)
        self.conv2 = _conv(cout, cout, 3, 1, dt, device)
        self.bn2 = BatchNormInference(cout, device=device)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride, dt, device),
                                            BatchNormInference(cout, device=device))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + h)


class Resnet18(nn.Module):
    def __init__(self, dt=torch.float32, device=None):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, dt, device)
        self.bn1 = BatchNormInference(64, device=device)
        cin = 64
        for i, (ch, stride) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                BasicBlock(cin, ch, stride, dt, device), BasicBlock(ch, ch, 1, dt, device)))
            cin = ch

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        feat8 = self.layer2(self.layer1(h))
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


def _mean_hw(x):
    """The fp32 global average over H, W, back in x's dtype."""
    return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


def _gate(x):
    """sigmoid in fp32, back in x's dtype."""
    return torch.sigmoid(x.float()).to(x.dtype)


class ARM(nn.Module):
    """AttentionRefinementModule: conv-bn-relu, then a global sigmoid gate."""

    def __init__(self, cin, cout, dt=torch.float32, device=None):
        super().__init__()
        self.conv = ConvBN(cin, cout, dt=dt, device=device)
        self.conv_atten = _conv(cout, cout, 1, 1, dt, device)
        self.bn_atten = BatchNormInference(cout, device=device)

    def forward(self, x):
        feat = self.conv(x)
        att = self.bn_atten(self.conv_atten(_mean_hw(feat)))
        return feat * _gate(att)


class ContextPath(nn.Module):
    def __init__(self, dt=torch.float32, device=None):
        super().__init__()
        self.resnet = Resnet18(dt, device)
        self.arm16 = ARM(256, 128, dt, device)
        self.arm32 = ARM(512, 128, dt, device)
        self.conv_head32 = ConvBN(128, 128, dt=dt, device=device)
        self.conv_head16 = ConvBN(128, 128, dt=dt, device=device)
        self.conv_avg = ConvBN(512, 128, ks=1, dt=dt, device=device)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(_mean_hw(feat32))
        f32 = self.arm32(feat32) + avg  # broadcast over H, W
        f32_up = self.conv_head32(F.interpolate(f32, scale_factor=2, mode="nearest"))
        f16 = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(F.interpolate(f16, scale_factor=2, mode="nearest"))
        return feat8, f16_up, f32_up


class FFM(nn.Module):
    """FeatureFusionModule: 1x1 conv-bn-relu over the concatenation, then a
    squeeze-and-excite gate added back."""

    def __init__(self, cin, cout, dt=torch.float32, device=None):
        super().__init__()
        self.convblk = ConvBN(cin, cout, ks=1, dt=dt, device=device)
        self.conv1 = _conv(cout, cout // 4, 1, 1, dt, device)
        self.conv2 = _conv(cout // 4, cout, 1, 1, dt, device)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], 1))
        att = self.conv2(F.relu(self.conv1(_mean_hw(feat))))
        return feat * _gate(att) + feat


class OutputHead(nn.Module):
    def __init__(self, cin, mid, n_classes, dt=torch.float32, device=None):
        super().__init__()
        self.conv = ConvBN(cin, mid, dt=dt, device=device)
        self.conv_out = _conv(mid, n_classes, 1, 1, dt, device)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    def __init__(self, config: BiSeNetConfig = BiSeNetConfig(), device=None):
        super().__init__()
        self.config = config
        dt, n = config.dtype, config.n_classes
        self.cp = ContextPath(dt, device)
        self.ffm = FFM(256, 256, dt, device)
        self.conv_out = OutputHead(256, 256, n, dt, device)
        self.conv_out16 = OutputHead(128, 64, n, dt, device)
        self.conv_out32 = OutputHead(128, 64, n, dt, device)

    def forward(self, x, aux_heads: bool = False):
        """x: (B, 3, H, W) ImageNet-normalized. Returns (B, n_classes, H, W)
        fp32 logits; aux_heads also returns the 16 and 32 heads'."""
        h0, w0 = x.shape[-2:]
        up = lambda t: resize_bilinear_align_corners(t.float(), h0, w0)
        feat8, f16_up, f32_up = self.cp(x.to(self.config.dtype))
        out = up(self.conv_out(self.ffm(feat8, f16_up)))
        if not aux_heads:
            return out
        return out, up(self.conv_out16(f16_up)), up(self.conv_out32(f32_up))


def parse_faces(model: BiSeNet, images01: torch.Tensor, remap_lut=None) -> torch.Tensor:
    """(B, 3, H, W) images in [0,1] -> (B, H, W) int32 class map (19-class,
    or remapped through `remap_lut`, e.g. FACE_PARSING_TO_SEG12). The argmax
    takes the first class among equal logits."""
    r = lambda a: torch.as_tensor(a, device=images01.device).reshape(1, 3, 1, 1)
    logits = model((images01 - r(SEG_MEAN)) / r(SEG_STD))
    classes = torch.argmax(logits, dim=1)
    if remap_lut is not None:
        classes = torch.as_tensor(np.asarray(remap_lut), device=classes.device)[classes]
    return classes.to(torch.int32)
