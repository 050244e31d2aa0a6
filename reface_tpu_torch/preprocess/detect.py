"""Face boxes from parsing masks, batched (port of
reface_tpu/preprocess/detect.py).

The face box is the bounding box of the face classes of the BiSeNet class
map: the region dlib's detector box seeds the landmark predictor with.
"""

from __future__ import annotations

import torch

__all__ = ["face_bbox_from_mask", "FACE_CLASSES_SEG12"]

FACE_CLASSES_SEG12 = (1, 2, 3, 5, 6, 7, 9)  # lip/brows/eyes/nose/skin/ears/mouth


def face_bbox_from_mask(seg: torch.Tensor, face_classes=FACE_CLASSES_SEG12,
                        min_pixels: int = 16):
    """(B, H, W) int class map -> ((B, 4) [x0, y0, x1, y1] float boxes,
    (B,) valid). A map with fewer than min_pixels face pixels is not valid
    and gets the full frame as its box."""
    b, h, w = seg.shape
    face = torch.zeros(seg.shape, dtype=torch.bool, device=seg.device)
    for c in face_classes:
        face = face | (seg == c)
    valid = face.sum(dim=(1, 2)) >= min_pixels

    ys = torch.arange(h, device=seg.device)[None, :, None].expand(b, h, w)
    xs = torch.arange(w, device=seg.device)[None, None, :].expand(b, h, w)
    big = torch.iinfo(torch.int32).max
    lo = lambda t: torch.where(face, t, big).amin(dim=(1, 2))
    hi = lambda t: torch.where(face, t, -1).amax(dim=(1, 2))
    boxes = torch.stack([lo(xs), lo(ys), hi(xs), hi(ys)], 1).float()
    full = torch.tensor([0.0, 0.0, w - 1.0, h - 1.0], device=seg.device)
    return torch.where(valid[:, None], boxes, full), valid
