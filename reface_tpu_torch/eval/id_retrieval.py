"""ID retrieval and similarity (port of reface_tpu/eval/id_retrieval.py).

The reference's ID_retrieval.py embeds every true source and every swap
with ArcFace IR-SE-50 (a masked crop by the dataset's rule), takes the
(n_swaps, n_sources) cosine matrix and reports the Top-1 and Top-5
retrieval accuracy of each swap's true source and the mean cosine to it.
"""

from __future__ import annotations

import numpy as np
import torch

from reface_tpu_torch.eval.fid import batched

__all__ = ["embed_identities", "id_retrieval_metrics"]


def embed_identities(model: torch.nn.Module, images, batch_size: int = 64) -> np.ndarray:
    """(N, 112, 112, 3) ArcFace-ready crops in [-1, 1] -> (N, 512) l2-normed,
    through an IRSE50 on its device."""
    return batched(lambda m, x: m(x), model, images, batch_size)


def id_retrieval_metrics(swap_feats: np.ndarray, source_feats: np.ndarray,
                         true_idx: np.ndarray | None = None) -> dict:
    """Cosine retrieval of each swap's source.

    swap_feats: (N, D) l2-normed; source_feats: (M, D) l2-normed;
    true_idx: (N,) index of each swap's true source (default arange).
    """
    n = swap_feats.shape[0]
    if true_idx is None:
        true_idx = np.arange(n)
    sim = swap_feats @ source_feats.T  # (N, M) cosines
    order = np.argsort(-sim, axis=1)
    top1 = (order[:, 0] == true_idx).mean()
    top5 = np.any(order[:, :5] == true_idx[:, None], axis=1).mean()
    mean_cos = sim[np.arange(n), true_idx].mean()
    return {"top1": float(top1), "top5": float(top5), "mean_id_cosine": float(mean_cos)}
