"""CLIP-FID: the Fréchet distance on CLIP ViT-B/32 image features (port of
reface_tpu/eval/fid.py).

The reference's fid_score.py computes FID over CLIP ViT-B/32's 512-d image
embeddings (its InceptionV3 wrapper is rewired to clip_model.encode_image),
after CLIP's preprocess (bicubic resize to 224, centre crop; eval/protocol.py
::clip_fid_load), then the Fréchet formula on each set's mean and
covariance. The tower runs batched on its device; the matrix square root
runs on the host in float64 (scipy).
"""

from __future__ import annotations

import numpy as np
import torch

from reface_tpu_torch.nn.clip import CLIPVisionConfig

__all__ = ["CLIP_B32", "clip_features", "frechet_distance", "clip_fid"]

# openai/clip-vit-base-patch32's vision tower (bf16, the JAX default)
CLIP_B32 = CLIPVisionConfig(hidden=768, layers=12, heads=12, patch=32, image_size=224,
                            projection_dim=512)


@torch.inference_mode()
def batched(fn, model: torch.nn.Module, images, batch_size: int) -> np.ndarray:
    """fn(model, NCHW float32 chunk on the model's device) over (N, H, W, C)
    images in chunks of `batch_size` -> the concatenated fp32 numpy rows."""
    dev = next(model.parameters()).device
    out = []
    for i in range(0, len(images), batch_size):
        x = torch.as_tensor(np.asarray(images[i:i + batch_size]), device=dev)
        out.append(fn(model, x.float().permute(0, 3, 1, 2)).float().cpu().numpy())
    return np.concatenate(out, axis=0)


def clip_features(tower: torch.nn.Module, images01, batch_size: int = 64) -> np.ndarray:
    """(N, H, W, 3) images in [0, 1] -> (N, 512) CLIP features, through a
    CLIPVisionTower(CLIP_B32) on its device."""
    from reface_tpu_torch.pipelines.swap import clip_normalize

    return batched(lambda m, x: m(clip_normalize(x)), tower, images01, batch_size)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) in float64; an offset
    of eps on the diagonals when the square root is not finite. (The JAX
    package passes disp=False, which SciPy 1.17 deprecates and 1.18 drops;
    the square root is the same without it.)"""
    from scipy import linalg

    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def clip_fid(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Fréchet distance between two feature sets (N_a, D), (N_b, D)."""
    mu1, s1 = feats_a.mean(0), np.cov(feats_a, rowvar=False)
    mu2, s2 = feats_b.mean(0), np.cov(feats_b, rowvar=False)
    return frechet_distance(mu1, s1, mu2, s2)
