"""Landmark predictors (port of reface_tpu/nn/landmarks.py), NCHW.

- `LandmarkNet`: the batched 68-landmark heatmap CNN (strided conv blocks
  with GroupNorm(8), the deepest map upsampled x2 and fused with the 1/8
  map, an fp32 heatmap head and a soft-argmax); its GroupNorms are the
  plain fp32 form, unfused, as the JAX package's are.
- `landmark_fn_from_net`: the batched get_landmarks role, [-1,1] images to
  (B, 136) pixel coordinates.
- `landmark_fn_from_rert`, `landmark68_fn_from_rert`: the exact-ERT host
  landmark sources on the port's native library (native_ops.py).
- `LandmarkAuxHead`: the landmark head of the full training loss.

Output convention: (B, 136) pixel coordinates interleaved (x0, y0, x1, y1,
...) in input-image pixel space.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reface_tpu_torch.nn.layers import Conv2d, GroupNorm32, Linear
from reface_tpu_torch.ops.resize import resize_bilinear_aa

__all__ = [
    "LandmarkNetConfig",
    "LandmarkNet",
    "LandmarkAuxHead",
    "soft_argmax_2d",
    "landmark_fn_from_net",
    "landmark_fn_from_rert",
    "landmark68_fn_from_rert",
]


def soft_argmax_2d(heatmaps: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W) heatmaps -> (B, K, 2) expected (x, y) in pixel units."""
    b, k, h, w = heatmaps.shape
    prob = torch.softmax(heatmaps.float().reshape(b, k, h * w), dim=-1)
    xs = torch.arange(w, dtype=torch.float32, device=heatmaps.device)
    ys = torch.arange(h, dtype=torch.float32, device=heatmaps.device)
    grid_x, grid_y = xs.repeat(h), ys.repeat_interleave(w)
    return torch.stack([prob @ grid_x, prob @ grid_y], -1)


@dataclasses.dataclass(frozen=True)
class LandmarkNetConfig:
    num_points: int = 68
    input_size: int = 256
    widths: tuple = (32, 64, 128, 256)
    dtype: torch.dtype = torch.bfloat16


class _Block(nn.Module):
    """3x3 stride-2 conv, GroupNorm(8), SiLU, 3x3 conv, GroupNorm(8), SiLU."""

    def __init__(self, cin: int, cout: int, dtype, device=None):
        super().__init__()
        self.down = Conv2d(cin, cout, 3, stride=2, padding=1, dtype=dtype, device=device)
        self.norm = GroupNorm32(cout, num_groups=8, device=device)
        self.conv = Conv2d(cout, cout, 3, padding=1, dtype=dtype, device=device)
        self.norm2 = GroupNorm32(cout, num_groups=8, device=device)

    def forward(self, x):
        h = F.silu(self.norm(self.down(x)))
        return F.silu(self.norm2(self.conv(h)))


class LandmarkNet(nn.Module):
    """(B, 3, S, S) in [-1,1] -> (B, 136) pixel coordinates at input scale.

    A heatmap head at 1/8 resolution and a soft-argmax; the heatmap conv
    keeps fp32 weights and computes in fp32 whatever the config's dtype."""

    def __init__(self, config: LandmarkNetConfig = LandmarkNetConfig(), device=None):
        super().__init__()
        self.config = config
        dt, w = config.dtype, config.widths
        cins = (3,) + tuple(w[:-1])
        for i, (cin, cout) in enumerate(zip(cins, w)):
            setattr(self, f"block_{i}", _Block(cin, cout, dt, device))
        self.fuse = Conv2d(w[-1] + w[2], w[-1], 3, padding=1, dtype=dt, device=device)
        self.fuse_norm = GroupNorm32(w[-1], num_groups=8, device=device)
        self.heat = Conv2d(w[-1], config.num_points, 1, dtype=torch.float32,
                           device=device)

    def forward(self, x):
        s = x.shape[-1]
        h = x.to(self.config.dtype)
        for i in range(len(self.config.widths)):
            h = getattr(self, f"block_{i}")(h)
            if i == 2:
                feat8 = h
        # the deepest map back to 1/8, fused with the 1/8 map
        h = torch.cat([F.interpolate(h, scale_factor=2, mode="nearest"), feat8], 1)
        h = F.silu(self.fuse_norm(self.fuse(h)))
        heat = self.heat(h)
        pts = soft_argmax_2d(heat) * (s / heat.shape[-2])
        return pts.reshape(x.shape[0], self.config.num_points * 2)


def landmark_fn_from_net(net: LandmarkNet, image_size: int):
    """Batched landmark-conditioning fn: (B, S, S, 3) NHWC images in [-1,1]
    -> (B, 136) pixel coordinates at `image_size` scale, on the net's
    device (the train/inference-time get_landmarks role)."""
    s = net.config.input_size

    @torch.inference_mode()
    def fn(images_pm1):
        dev = next(net.parameters()).device
        x = torch.as_tensor(images_pm1, device=dev).float().permute(0, 3, 1, 2)
        return net(resize_bilinear_aa(x, s, s)) * (image_size / s)

    return fn


def _rert_gray(images, lo: float) -> np.ndarray:
    """(B, H, W, 3) images in [lo, 1] -> (B, H, W) uint8 luma in [0, 255]."""
    g = np.asarray(images.cpu() if isinstance(images, torch.Tensor) else images,
                   np.float32)
    gray = g[..., 0] * 0.299 + g[..., 1] * 0.587 + g[..., 2] * 0.114
    return np.clip((gray - lo) * (255.0 / (1.0 - lo)), 0, 255).astype(np.uint8)


def _full_boxes(b: int, h: int, w: int) -> np.ndarray:
    return np.tile(np.array([0, 0, w - 1, h - 1], np.float32), (b, 1))


def landmark_fn_from_rert(path: str, image_size: int):
    """Host exact-ERT landmark fn over a batch of [-1,1] NHWC images ->
    (B, 136) np.float32 at `image_size` scale: the native ERT cascade with
    full-image boxes (the get_landmarks fallback box)."""
    from reface_tpu_torch import native_ops

    native_ops.ert_load(path)

    def fn(images_pm1):
        gray = _rert_gray(images_pm1, -1.0)
        b, h, w = gray.shape
        lm = native_ops.ert_predict_batch(gray, _full_boxes(b, h, w)).reshape(b, 136)
        return lm * (image_size / w)

    return fn


def landmark68_fn_from_rert(path: str):
    """Host exact-ERT landmark fn for the raw pipeline: (B, H, W, 3) NHWC
    images in [0,1] (numpy or tensors) -> (B, 68, 2) np.float32 pixel
    coordinates at the input scale, at the image's own resolution with the
    full-image box (RawSwapPipeline's landmark_fn)."""
    from reface_tpu_torch import native_ops

    native_ops.ert_load(path)

    def fn(images01):
        gray = _rert_gray(images01, 0.0)
        b, h, w = gray.shape
        return native_ops.ert_predict_batch(gray, _full_boxes(b, h, w)).reshape(b, 68, 2)

    return fn


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
