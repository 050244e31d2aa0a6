"""CLIP ViT-L/14 vision tower + trainable mapper head (port of
reface_tpu/nn/clip.py), NCHW input.

Module names follow the REFace checkpoint's `cond_stage_model.*`: the HF
CLIPModel vision tower under `model.vision_model` and
`model.visual_projection`, then `mapper2.resblocks.*` and `final_ln2`.

Dtype policy as in the JAX package: the products run in `dtype`, the
LayerNorms in fp32 with fp32 outputs, so the residual stream is fp32. The
257-token attention is a plain product (the JAX package leaves it to XLA).
CLIPVisionConfig.quant="int8" (the --quant-cond serving mode) runs every
layer's q/k/v/out projections and MLP products int8 (ops/quant.py); the
patch embedding, the projection and the mapper stay in the compute dtype.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from reface_tpu_torch.nn.layers import Conv2d, LayerNorm, Linear, check_quant
from reface_tpu_torch.ops.attention_smalld import einsum_attention

__all__ = ["CLIPVisionConfig", "CLIPVisionTower", "MapperTransformer",
           "CLIPConditioner"]


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    patch: int = 14
    image_size: int = 224
    projection_dim: int = 768
    dtype: torch.dtype = torch.bfloat16
    # "int8": the tower's transformer products (module docstring)
    quant: str = "none"

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch) ** 2 + 1


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype, quant: str = "none",
                 device=None):
        super().__init__()
        self.heads = heads
        kw = dict(dtype=dtype, device=device, quant=quant)
        self.q_proj = Linear(hidden, hidden, **kw)
        self.k_proj = Linear(hidden, hidden, **kw)
        self.v_proj = Linear(hidden, hidden, **kw)
        self.out_proj = Linear(hidden, hidden, **kw)

    def forward(self, x):
        b, n, c = x.shape
        d = c // self.heads
        split = lambda t: t.reshape(b, n, self.heads, d).transpose(1, 2)
        o = einsum_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                             split(self.v_proj(x)), d**-0.5)
        return self.out_proj(o.transpose(1, 2).reshape(b, n, c))


class _MLP(nn.Module):
    def __init__(self, hidden, dtype, quant, device):
        super().__init__()
        self.fc1 = Linear(hidden, hidden * 4, dtype=dtype, device=device, quant=quant)
        self.fc2 = Linear(hidden * 4, hidden, dtype=dtype, device=device, quant=quant)


class CLIPLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype, quant: str = "none",
                 device=None):
        super().__init__()
        self.self_attn = CLIPAttention(hidden, heads, dtype, quant, device)
        self.layer_norm1 = LayerNorm(hidden, device=device)
        self.mlp = _MLP(hidden, dtype, quant, device)
        self.layer_norm2 = LayerNorm(hidden, device=device)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        h = quick_gelu(self.mlp.fc1(self.layer_norm2(x)))
        return x + self.mlp.fc2(h)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden, device=device))
        self.patch_embedding = Conv2d(3, cfg.hidden, cfg.patch, stride=cfg.patch,
                                      bias=False, dtype=cfg.dtype, device=device)
        self.position_embedding = nn.Embedding(cfg.num_tokens, cfg.hidden,
                                               device=device)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device):
        super().__init__()
        self.layers = nn.ModuleList([
            CLIPLayer(cfg.hidden, cfg.heads, cfg.dtype, cfg.quant, device)
            for _ in range(cfg.layers)])


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device):
        super().__init__()
        self.embeddings = _Embeddings(cfg, device)
        self.pre_layrnorm = LayerNorm(cfg.hidden, device=device)  # HF's key
        self.encoder = _Encoder(cfg, device)
        self.post_layernorm = LayerNorm(cfg.hidden, device=device)


class CLIPVisionTower(nn.Module):
    """(B, 3, 224, 224) CLIP-normalized -> (B, projection_dim) fp32."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig(), device=None):
        super().__init__()
        check_quant(config.quant)
        self.config = config
        self.vision_model = _VisionModel(config, device)
        self.visual_projection = Linear(config.hidden, config.projection_dim,
                                        bias=False, device=device)

    def forward(self, x):
        cfg = self.config
        emb = self.vision_model.embeddings
        b = x.shape[0]
        patches = emb.patch_embedding(x).flatten(2).transpose(1, 2)
        cls = emb.class_embedding.to(cfg.dtype).expand(b, 1, cfg.hidden)
        h = torch.cat([cls, patches], dim=1)
        h = h + emb.position_embedding.weight.to(cfg.dtype)[None]
        h = self.vision_model.pre_layrnorm(h)
        for layer in self.vision_model.encoder.layers:
            h = layer(h)
        pooled = self.vision_model.post_layernorm(h[:, 0])
        return self.visual_projection(pooled)


class _MapperAttention(nn.Module):
    def __init__(self, width, kw):
        super().__init__()
        self.c_qkv = Linear(width, width * 3, **kw)
        self.c_proj = Linear(width, width, **kw)


class _MapperMLP(nn.Module):
    def __init__(self, width, kw):
        super().__init__()
        self.c_fc = Linear(width, width * 4, **kw)
        self.c_proj = Linear(width * 4, width, **kw)


class MapperBlock(nn.Module):
    """Pre-LN residual block with fused-qkv attention."""

    def __init__(self, width: int, heads: int, dtype, param_dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.heads = heads
        self.ln_1 = LayerNorm(width, device=device)
        self.attn = _MapperAttention(width, kw)
        self.ln_2 = LayerNorm(width, device=device)
        self.mlp = _MapperMLP(width, kw)

    def forward(self, x):
        b, n, w = x.shape
        d = w // self.heads
        qkv = self.attn.c_qkv(self.ln_1(x)).reshape(b, n, self.heads, 3 * d)
        q, k, v = (t.transpose(1, 2) for t in torch.chunk(qkv, 3, dim=-1))
        att = einsum_attention(q, k, v, d**-0.5).transpose(1, 2).reshape(b, n, w)
        x = x + self.attn.c_proj(att)
        h = F.gelu(self.mlp.c_fc(self.ln_2(x)), approximate="none")
        return x + self.mlp.c_proj(h)


class MapperTransformer(nn.Module):
    """The trainable 5-layer/width-768/1-head mapper over a single token."""

    def __init__(self, width: int = 768, layers: int = 5, heads: int = 1,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList([
            MapperBlock(width, heads, dtype, param_dtype, device)
            for _ in range(layers)])

    def forward(self, x):
        for blk in self.resblocks:
            x = blk(x)
        return x


class CLIPConditioner(nn.Module):
    """Frozen CLIP tower + mapper2/final_ln2 head:
    (B,3,224,224) CLIP-normalized -> (B, 1, 768) fp32.

    param_dtype: storage dtype of the trainable mapper's weights (training
    keeps them in fp32); the frozen tower keeps its compute dtype."""

    def __init__(self, vision: CLIPVisionConfig = CLIPVisionConfig(), device=None,
                 param_dtype=None):
        super().__init__()
        self.model = CLIPVisionTower(vision, device=device)
        self.mapper2 = MapperTransformer(dtype=vision.dtype,
                                         param_dtype=param_dtype, device=device)
        self.final_ln2 = LayerNorm(768, device=device)

    def forward(self, x):
        z = self.model(x)[:, None, :]
        return self.final_ln2(self.mapper2(z))
