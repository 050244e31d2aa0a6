"""Seeded pre-cropped pairs and training rows, made on the device.

A pair is what REFace's test bench feeds the swap after its crop: a target
image in [-1, 1], a keep mask (1 = keep) with a face-shaped ellipse cut out
of it, the masked target, the source's CLIP-normalised 224 px crop, and the
target's 68 landmarks in pixels (x, y interleaved, on the ellipse's
outline and inside it). Images are smooth random fields: a coarse normal
grid upsampled, plus fine noise, squashed into range. Every size and count
is fixed by the traffic file; the seed picks only the values.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference.nets import CLIP_MEAN, CLIP_STD


def _field(n: int, size: int, gen, device):
    coarse = torch.randn((n, 3, 16, 16), generator=gen, device=device)
    fine = torch.randn((n, 3, size, size), generator=gen, device=device)
    x = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    return torch.tanh(0.8 * x + 0.15 * fine)  # (n, 3, size, size) in (-1, 1)


def make_pairs(n: int, size: int, seed: int, device) -> dict:
    """n pairs as the program takes them: NHWC fp32 target_image,
    inpaint_image, inpaint_mask, ref_clip224, and landmarks (n, 136)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    target = _field(n, size, gen, device)
    # the face: an ellipse near the centre, its size and place drawn per pair
    u = torch.rand((n, 4), generator=gen, device=device)
    cy, cx = size * (0.45 + 0.1 * u[:, 0]), size * (0.45 + 0.1 * u[:, 1])
    ry, rx = size * (0.22 + 0.08 * u[:, 2]), size * (0.17 + 0.06 * u[:, 3])
    yy = torch.arange(size, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(size, device=device, dtype=torch.float32)[None, None, :]
    inside = ((yy - cy[:, None, None]) / ry[:, None, None]) ** 2 \
        + ((xx - cx[:, None, None]) / rx[:, None, None]) ** 2 < 1.0
    mask = (~inside).float()[:, None]  # (n, 1, size, size), 1 = keep
    # 17 points on the jaw's arc, 51 inside the face
    ang = torch.linspace(0.15 * math.pi, 0.85 * math.pi, 17, device=device)[None]
    jaw_y, jaw_x = cy[:, None] + ry[:, None] * torch.sin(ang), cx[:, None] - rx[:, None] * torch.cos(ang)
    r = torch.rand((n, 51, 2), generator=gen, device=device) * 1.2 - 0.6
    in_y, in_x = cy[:, None] + ry[:, None] * r[..., 0], cx[:, None] + rx[:, None] * r[..., 1]
    lm = torch.stack([torch.cat([jaw_x, in_x], 1), torch.cat([jaw_y, in_y], 1)], dim=-1)
    src01 = (_field(n, 224, gen, device) + 1.0) / 2.0
    chw = lambda a: torch.tensor(a, device=device).reshape(1, 3, 1, 1)
    ref = (src01 - chw(CLIP_MEAN)) / chw(CLIP_STD)
    nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()
    return {
        "target_image": nhwc(target),
        "inpaint_image": nhwc(target * mask),
        "inpaint_mask": nhwc(mask),
        "ref_clip224": nhwc(ref),
        "landmarks": lm.reshape(n, 136).contiguous(),
    }


def rows(pairs: dict, idx) -> dict:
    """The pairs at the given indices."""
    return {k: v[idx] for k, v in pairs.items()}


def to_nchw(pairs: dict) -> dict:
    """The reference's layout: target, inpaint, mask, ref_clip224 NCHW fp32."""
    c = lambda t: t.permute(0, 3, 1, 2).contiguous().float()
    return {"target": c(pairs["target_image"]), "inpaint": c(pairs["inpaint_image"]),
            "mask": c(pairs["inpaint_mask"]), "ref_clip224": c(pairs["ref_clip224"]),
            "landmarks": pairs["landmarks"].float()}
