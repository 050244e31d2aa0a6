"""Safety checker: flag and blur NSFW outputs (port of reface_tpu/nn/safety.py).

The CLIP ViT-L/14 image embedding of each output (nn/clip.py's
CLIPVisionTower with its visual projection) is compared by cosine with
fixed "concept" embeddings against per-concept thresholds, with diffusers'
StableDiffusionSafetyChecker scoring: the special-care scores first, with
the global adjustment (applied to them only); a special-care hit adds 0.01
to that image's concept scores; an image is flagged when any concept score
is above 0. A flagged image is replaced by its blur, an antialiased
bilinear resize to 1/16 and back (jax.image.resize's semantics).

The state dict is diffusers' with the tower under `tower.`
(ckpt/from_torch.py::safety_state_dict routes it). Without weights the
checker passes images through and flags none, as the JAX one does.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from reface_tpu_torch.nn.clip import CLIPVisionConfig, CLIPVisionTower
from reface_tpu_torch.ops.resize import resize_bilinear_aa

__all__ = ["SafetyCheckerConfig", "SafetyChecker"]


@dataclasses.dataclass(frozen=True)
class SafetyCheckerConfig:
    clip: CLIPVisionConfig = CLIPVisionConfig()
    n_concepts: int = 17
    n_special: int = 3
    # added to the special-care scores ("lower value => stronger filter")
    adjustment: float = 0.0


class SafetyChecker(nn.Module):
    """checker(images01) -> (filtered01, flags): NHWC [0,1] images in and
    out, flags (B,) bool. params: the checker's state dict, or None for the
    pass-through."""

    def __init__(self, config: SafetyCheckerConfig = SafetyCheckerConfig(),
                 params: dict | None = None, device=None):
        super().__init__()
        self.config = config
        self.tower = CLIPVisionTower(config.clip, device=device)
        proj = config.clip.projection_dim
        for name, n in (("concept_embeds", config.n_concepts),
                        ("special_care_embeds", config.n_special)):
            self.register_buffer(name, torch.zeros(n, proj, device=device))
            self.register_buffer(f"{name}_weights", torch.zeros(n, device=device))
        self.loaded = params is not None
        if params is not None:
            self.load_state_dict(params)
        self.eval().requires_grad_(False)

    @staticmethod
    def _cos(emb, concepts):
        return emb @ (concepts / concepts.norm(dim=-1, keepdim=True)).T

    def flags(self, images01: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) [0,1] -> (B,) bool."""
        from reface_tpu_torch.pipelines.swap import clip_normalize

        emb = self.tower(clip_normalize(images01)).float()
        emb = emb / emb.norm(dim=-1, keepdim=True)
        special = (self._cos(emb, self.special_care_embeds) - self.special_care_embeds_weights
                   + self.config.adjustment)
        per_image = torch.where((special > 0).any(dim=-1), 0.01, 0.0)[:, None]
        concept = self._cos(emb, self.concept_embeds) - self.concept_embeds_weights + per_image
        return (concept > 0).any(dim=-1)

    @staticmethod
    def blur(images01: torch.Tensor, factor: int = 16) -> torch.Tensor:
        """(B, 3, H, W) -> its antialiased bilinear resize to 1/factor and back."""
        h, w = images01.shape[2:]
        small = resize_bilinear_aa(images01, h // factor, w // factor)
        return resize_bilinear_aa(small, h, w)

    @torch.inference_mode()
    def forward(self, images01):
        x = torch.as_tensor(images01, device=self.concept_embeds.device).float()
        if not self.loaded:
            return x, torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        x = x.permute(0, 3, 1, 2)
        flags = self.flags(x)
        out = torch.where(flags[:, None, None, None], self.blur(x), x)
        return out.permute(0, 2, 3, 1).contiguous(), flags
