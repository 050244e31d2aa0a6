"""REFace conditioning fusion (port of reface_tpu/nn/conditioner.py):
CLIP(src) + CLIP(tar) + ArcFace ID + landmarks -> (B, 1, 768).

    c = (1*c_clip + 10*c_id + 0.05*c_lm) / 11.05

Module names are those of the REFace checkpoint's top level:
`cond_stage_model.*` (CLIP tower + mapper), `face_ID_model.facenet.*`
(IR-SE-50), `proj_out_source`, `proj_out_target`, `ID_proj_out`,
`landmark_proj_out` and the CFG null token `learnable_vector`.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from reface_tpu_torch.nn.arcface import ArcFaceConfig, IRSE50, arcface_preprocess_from_clip
from reface_tpu_torch.nn.clip import CLIPConditioner, CLIPVisionConfig
from reface_tpu_torch.nn.layers import Linear

__all__ = ["ConditionerConfig", "REFaceConditioner"]


@dataclasses.dataclass(frozen=True)
class ConditionerConfig:
    clip_weight: float = 1.0
    id_weight: float = 10.0
    landmark_weight: float = 0.05
    weight_division: bool = True
    landmark_cond: bool = True
    context_dim: int = 768
    landmark_dim: int = 136
    clip: CLIPVisionConfig = CLIPVisionConfig()
    arcface: ArcFaceConfig = ArcFaceConfig()


class REFaceConditioner(nn.Module):
    """Produces the (B, 1, 768) cross-attention context and the CFG null token.

    param_dtype: storage dtype of the trainable heads' weights (the mapper
    and the fp32 projections); the frozen CLIP and IR-SE-50 towers keep
    their compute dtype."""

    def __init__(self, config: ConditionerConfig = ConditionerConfig(), device=None,
                 param_dtype=None):
        super().__init__()
        self.config = cfg = config
        d = cfg.context_dim
        kw = dict(param_dtype=param_dtype, device=device)
        self.cond_stage_model = CLIPConditioner(cfg.clip, **kw)
        self.face_ID_model = nn.Module()
        self.face_ID_model.facenet = IRSE50(cfg.arcface, device=device)
        self.proj_out_source = Linear(cfg.clip.projection_dim, d, **kw)
        self.proj_out_target = Linear(cfg.clip.projection_dim, d, **kw)
        self.ID_proj_out = Linear(cfg.arcface.embed_dim, d, **kw)
        self.landmark_proj_out = Linear(cfg.landmark_dim, d, **kw)
        self.learnable_vector = nn.Parameter(torch.zeros(1, 1, d, device=device))

    def fuse(self, c_clip, c_id, c_lm=None):
        """Weighted fusion of already-projected (B,1,768) streams."""
        cfg = self.config
        total = cfg.clip_weight * c_clip + cfg.id_weight * c_id
        denom = cfg.clip_weight + cfg.id_weight
        if cfg.landmark_cond and c_lm is not None:
            total = total + cfg.landmark_weight * c_lm
            denom = denom + cfg.landmark_weight
        return total / denom if cfg.weight_division else total

    def forward(self, ref_clip224, tar_clip224, landmarks=None):
        """ref/tar: (B,3,224,224) CLIP-normalized; landmarks: (B,136).

        Source and target ride the CLIP tower as one 2B batch."""
        b = ref_clip224.shape[0]
        z = self.cond_stage_model(torch.cat([ref_clip224, tar_clip224], dim=0))
        c_clip = self.proj_out_source(z[:b]) + self.proj_out_target(z[b:])
        face = self.face_ID_model.facenet(arcface_preprocess_from_clip(ref_clip224))
        c_id = self.ID_proj_out(face)[:, None, :]
        c_lm = None
        if self.config.landmark_cond and landmarks is not None:
            c_lm = self.landmark_proj_out(landmarks.float())[:, None, :]
        return self.fuse(c_clip, c_id, c_lm)

    def null_conditioning(self, batch: int):
        """CFG unconditional context (B, 1, 768)."""
        return self.learnable_vector.expand(batch, 1, self.config.context_dim)
