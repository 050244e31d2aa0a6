"""The reference protocol's preprocessing for the evaluation harness (port of
reface_tpu/eval/protocol.py).

Each helper reproduces one loader of the reference's eval_tool, so that the
metrics compare with its numbers. The reads go through io/images.py, which
gives PIL's and cv2's pixels without either library:

  clip_fid_load       fid/fid_score.py:66-80: CLIP ViT-B/32's preprocess,
                      a shorter-edge PIL bicubic resize to 224 and a centre
                      crop, [0, 1] floats (CLIP normalisation happens inside
                      clip_features).
  id_masked_112_load  ID_retrieval/ID_retrieval.py:171-250: a cv2 RGB read,
                      INTER_LINEAR to 112, CLIP normalisation, times the
                      dataset rule's preserve mask (the 19-class mask read
                      with PIL's convert("L"), binarised, resized to 112
                      bilinear without antialias, torchvision's tensor
                      Resize).
  id_embed_protocol   ID_retrieval.py:104-140 (IDLoss): adaptive pool to
                      256, crop [35:223, 32:220], pool to 112, IR-SE-50.
  hopenet_load        Pose/pose_compare.py:82-99: ToTensor, tensor Resize
                      (224, 224) bilinear without antialias; the ImageNet
                      normalisation is inside pose_angles.
  expression_load     Expression/expression_compare_face_recon.py:105-128:
                      PIL bicubic resize to (512, 512), / 255.

The eval-time preserve lists (ID_retrieval.py:204-212) differ from the
training mask recipes: CelebA's drops hair (17).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from reface_tpu_torch.eval.fid import batched
from reface_tpu_torch.io.images import (
    imread,
    open_rgb,
    resize_bicubic_pil,
    resize_linear,
    to_gray_pil,
)
from reface_tpu_torch.nn.arcface import ARC_FACE_CROP, CLIP_MEAN, CLIP_STD
from reface_tpu_torch.ops.pooling import adaptive_avg_pool2d
from reface_tpu_torch.ops.resize import resize_bilinear_no_aa

__all__ = [
    "ID_EVAL_PRESERVE",
    "clip_fid_load",
    "id_masked_112_load",
    "id_embed_protocol",
    "hopenet_load",
    "expression_load",
    "parse_file_number",
]

# ID_retrieval.py:204-212
ID_EVAL_PRESERVE = {
    "celeba": (1, 2, 4, 5, 8, 9, 6, 7, 10, 11, 12),
    "ffhq": (1, 2, 3, 5, 6, 7, 9),
    "ff++": (1, 2, 4, 5, 8, 9),
    "none": tuple(range(21)),
}


def _resize_no_aa(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) float32 -> (size, size, C), bilinear without antialias."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    return resize_bilinear_no_aa(x, size, size)[0].permute(1, 2, 0).numpy()


def clip_fid_load(paths, size: int = 224) -> np.ndarray:
    """CLIP's preprocess (bicubic shorter-edge resize, centre crop) ->
    (N, size, size, 3) float32 in [0, 1]."""
    out = np.zeros((len(paths), size, size, 3), np.float32)
    for i, p in enumerate(paths):
        img = open_rgb(p)
        h, w = img.shape[:2]
        scale = size / min(w, h)
        nw, nh = round(w * scale), round(h * scale)
        img = resize_bicubic_pil(img, nh, nw)
        left, top = (nw - size) // 2, (nh - size) // 2
        out[i] = img[top:top + size, left:left + size] / np.float32(255.0)
    return out


def id_masked_112_load(image_paths, mask_paths, dataset: str = "celeba") -> np.ndarray:
    """Masked, CLIP-normalized 112 px crops for the ID metric: (N, 112, 112,
    3) float32, the image at 112 (cv2 INTER_LINEAR) times the preserve-class
    mask at 112 (bilinear without antialias)."""
    preserve = ID_EVAL_PRESERVE[dataset]
    out = np.zeros((len(image_paths), 112, 112, 3), np.float32)
    for i, (ip, mp) in enumerate(zip(image_paths, mask_paths)):
        img = resize_linear(imread(ip), 112, 112)
        x = (img.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
        m01 = np.isin(to_gray_pil(open_rgb(mp)), preserve).astype(np.float32)
        out[i] = x * _resize_no_aa(m01[..., None], 112)
    return out


def id_embed_protocol(model: torch.nn.Module, images112, batch_size: int = 64) -> np.ndarray:
    """IDLoss.extract_feats on normalized 112 px inputs: AdaptiveAvgPool2d
    (256) -> crop [35:223, 32:220] -> AdaptiveAvgPool2d(112) -> IR-SE-50 on
    its device; (N, 512) l2-normed features."""

    def fwd(m, x):
        x = adaptive_avg_pool2d(x, 256, 256)
        t, b, l, r = ARC_FACE_CROP
        return m(adaptive_avg_pool2d(x[:, :, t:b, l:r], 112, 112))

    return batched(fwd, model, images112, batch_size)


def hopenet_load(paths, size: int = 224) -> np.ndarray:
    """(N, size, size, 3) in [0, 1]: tensor-mode Resize (bilinear, no AA)."""
    out = np.zeros((len(paths), size, size, 3), np.float32)
    for i, p in enumerate(paths):
        img = open_rgb(p).astype(np.float32) / 255.0
        out[i] = img if img.shape[:2] == (size, size) else _resize_no_aa(img, size)
    return out


def expression_load(paths, size: int = 512) -> np.ndarray:
    """(N, size, size, 3) in [0, 1]: PIL bicubic resize to (size, size), / 255."""
    out = np.zeros((len(paths), size, size, 3), np.float32)
    for i, p in enumerate(paths):
        out[i] = resize_bicubic_pil(open_rgb(p), size, size).astype(np.float32) / 255.0
    return out


def parse_file_number(name: str) -> int | None:
    """First integer among the [_/.-]-separated parts of a file name
    (ID_retrieval.py:325-340's pairing rule)."""
    for part in re.split(r"[_\/.\-]", name):
        if part.isdigit():
            return int(part)
    return None
