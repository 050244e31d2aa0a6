"""The evaluation metrics of the reference's test bench (port of
reface_tpu/eval): CLIP-FID, ID retrieval, pose and expression, with their
towers and the reference protocol's loaders (eval/protocol.py)."""

from reface_tpu_torch.eval.fid import CLIP_B32, clip_features, clip_fid, frechet_distance
from reface_tpu_torch.eval.id_retrieval import embed_identities, id_retrieval_metrics
from reface_tpu_torch.eval.pose import pose_angles, pose_l2
from reface_tpu_torch.eval.expression import expression_coeffs, expression_l2
from reface_tpu_torch.eval.backbones import (
    FaceReconCoeffNet,
    Hopenet,
    ResNet50,
    decode_hopenet_angles,
)

__all__ = [
    "CLIP_B32",
    "clip_features",
    "clip_fid",
    "frechet_distance",
    "embed_identities",
    "id_retrieval_metrics",
    "pose_angles",
    "pose_l2",
    "expression_coeffs",
    "expression_l2",
    "FaceReconCoeffNet",
    "Hopenet",
    "ResNet50",
    "decode_hopenet_angles",
]
