"""Expression error: D3DFR expression-coefficient L2 (port of
reface_tpu/eval/expression.py).

The reference's expression_compare_face_recon.py runs Deep3DFaceRecon's
ResNet-50 regressor on the target and the swap and reports the mean L2
over the 64 expression coefficients (coeffs[80:144]); its CUDA rasterizer
is not needed for the coefficients.
"""

from __future__ import annotations

import numpy as np
import torch

from reface_tpu_torch.eval.backbones import FaceReconCoeffNet
from reface_tpu_torch.eval.fid import batched

__all__ = ["expression_coeffs", "expression_l2"]


def expression_coeffs(model: torch.nn.Module, images01, batch_size: int = 64) -> np.ndarray:
    """(N, H, W, 3) in [0, 1] -> (N, 64) expression coefficients, through a
    FaceReconCoeffNet on its device."""
    return batched(lambda m, x: FaceReconCoeffNet.split_coeffs(m(x))["exp"], model,
                   images01, batch_size)


def expression_l2(exp_target: np.ndarray, exp_swap: np.ndarray) -> float:
    return float(np.linalg.norm(exp_target - exp_swap, axis=1).mean())
