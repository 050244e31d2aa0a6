"""9-channel Stable-Diffusion-v1 UNet (port of reface_tpu/nn/unet.py), NCHW.

Module names are the reference torch checkpoint's (openaimodel.py), e.g.
`input_blocks.1.0.in_layers.2.weight`, so `model.diffusion_model.*` of a
REFace `last.ckpt` loads as it is.

Kernels on this path (on a CUDA tensor): the self-attention at 4096 and
1024 tokens runs K1 (ops/attention_smalld.py), or, with attn_impl="flash"
(training), the differentiable FlashAttention (ops/attention.py: the
residual K2 forward, K4/K5 in the backward); with fused_groupnorm=True the
ResBlock norms and the output norm run K3 (ops/groupnorm.py).

UNetConfig.quant, the int8 serving modes (ops/quant.py): "int8" runs the
ResBlock convs (in_layers.2, out_layers.3, skip_connection) and each
TransformerBlock's self-attention projections and GEGLU products int8;
"int8conv" the ResBlock convs only. The stem, head, up/downsample convs,
proj_in/proj_out, the time embedding and the cross-attention stay in the
compute dtype; with fused_groupnorm K3 feeds the int8 convs.

`param_dtype` (UNetModel's argument) stores the Linear/Conv weights in
another dtype than the compute dtype: training keeps them in fp32
(nn/layers.py). remat=True recomputes each ResBlock and SpatialTransformer
in the backward (torch.utils.checkpoint) while gradients are recorded.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from reface_tpu_torch.core.schedules import timestep_embedding
from reface_tpu_torch.nn.layers import (
    Conv2d,
    CrossAttention,
    FeedForwardGEGLU,
    GroupNorm32,
    LayerNorm,
    Linear,
    Upsample,
    check_quant,
)

__all__ = ["UNetConfig", "UNetModel", "decoder_feature_shapes", "ResBlock", "TransformerBlock",
           "SpatialTransformer", "Downsample", "Upsample"]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 9
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 2, 1)
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    dtype: torch.dtype = torch.bfloat16
    # recompute each ResBlock / SpatialTransformer in the backward (training)
    remat: bool = False
    # fuse GroupNorm+SiLU into kernel K3 (ops/groupnorm.py); same params
    fused_groupnorm: bool = False
    # self-attention: "auto" (K1 routing), "fast" (K1 without the softmax
    # shift), "flash" (differentiable, training), "einsum" (plain product)
    attn_impl: str = "auto"
    # "none" | "int8" | "int8conv" (module docstring)
    quant: str = "none"


class ResBlock(nn.Module):
    def __init__(self, channels: int, out_channels: int, emb_channels: int,
                 dtype=torch.float32, param_dtype=None, fused_gn: bool = False,
                 quant: str = "none", device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        qkw = dict(kw, quant=quant)  # the QConv sites
        self.fused_gn = fused_gn
        self.in_layers = nn.Sequential(
            GroupNorm32(channels, fuse_silu=fused_gn, device=device),
            nn.SiLU(), Conv2d(channels, out_channels, 3, padding=1, **qkw))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_channels, out_channels, **kw))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels, fuse_silu=fused_gn, device=device),
            nn.SiLU(), nn.Identity(),
            Conv2d(out_channels, out_channels, 3, padding=1, zero_init=True, **qkw))
        self.skip_connection = (
            nn.Identity() if channels == out_channels
            else Conv2d(channels, out_channels, 1, **qkw))

    def forward(self, x, emb):
        h = self.in_layers[0](x)
        if not self.fused_gn:
            h = F.silu(h)
        h = self.in_layers[2](h)
        e = self.emb_layers[1](F.silu(emb))
        h = h + e[:, :, None, None]
        h = self.out_layers[0](h)
        if not self.fused_gn:
            h = F.silu(h)
        h = self.out_layers[3](h)
        return self.skip_connection(x) + h


class TransformerBlock(nn.Module):
    def __init__(self, channels: int, num_heads: int, context_dim: int,
                 dtype=torch.float32, param_dtype=None, attn_impl: str = "auto",
                 quant: str = "none", device=None):
        super().__init__()
        d = channels // num_heads
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.attn1 = CrossAttention(channels, heads=num_heads, dim_head=d,
                                    attn_impl=attn_impl, quant=quant, **kw)
        self.ff = FeedForwardGEGLU(channels, quant=quant, **kw)
        self.attn2 = CrossAttention(channels, context_dim=context_dim,
                                    heads=num_heads, dim_head=d, **kw)
        self.norm1 = LayerNorm(channels, out_dtype=dtype, device=device)
        self.norm2 = LayerNorm(channels, out_dtype=dtype, device=device)
        self.norm3 = LayerNorm(channels, out_dtype=dtype, device=device)

    def forward(self, x, context, expand_cfg: bool = False):
        """expand_cfg: x is the shared CFG half-batch (B) and context is 2B;
        the batch doubles just before the cross-attention, the first op
        that reads the context (exact CFG prefix dedup)."""
        x = x + self.attn1(self.norm1(x))
        if expand_cfg:
            x = torch.cat([x, x], dim=0)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, num_heads: int, context_dim: int,
                 depth: int = 1, dtype=torch.float32, param_dtype=None,
                 attn_impl: str = "auto", quant: str = "none", device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm = GroupNorm32(channels, eps=1e-6, device=device)
        self.proj_in = Conv2d(channels, channels, 1, **kw)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(channels, num_heads, context_dim,
                             attn_impl=attn_impl, quant=quant, **kw)
            for _ in range(depth)])
        self.proj_out = Conv2d(channels, channels, 1, zero_init=True, **kw)

    def forward(self, x, context, expand_cfg: bool = False):
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x))
        h = h.reshape(b, c, hh * ww).transpose(1, 2)
        for i, blk in enumerate(self.transformer_blocks):
            h = blk(h, context, expand_cfg=expand_cfg and i == 0)
        h = h.transpose(1, 2).reshape(-1, c, hh, ww)
        h = self.proj_out(h)
        if expand_cfg:
            x = torch.cat([x, x], dim=0)
        return x + h


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1,
                         dtype=dtype, param_dtype=param_dtype, device=device)

    def forward(self, x):
        return self.op(x)


def decoder_feature_shapes(cfg: UNetConfig, latent: int) -> list[tuple[int, int]]:
    """(channels, spatial size) of each decoder block's output for a
    latent x latent input: the `return_features` list, from the config."""
    n = len(cfg.channel_mult)
    size = latent // 2 ** (n - 1)
    shapes = []
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            if level and i == cfg.num_res_blocks:
                size *= 2  # the block ends in an Upsample
            shapes.append((mult * cfg.model_channels, size))
    return shapes


class UNetModel(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig(), device=None,
                 param_dtype=None):
        super().__init__()
        cfg = self.config = config
        check_quant(cfg.quant)
        dt, mc = cfg.dtype, cfg.model_channels
        kw = dict(dtype=dt, param_dtype=param_dtype, device=device)
        emb_ch = mc * 4

        def res(cin, cout):
            return ResBlock(cin, cout, emb_ch, fused_gn=cfg.fused_groupnorm,
                            quant=cfg.quant, **kw)

        def attn(ch):
            return SpatialTransformer(ch, cfg.num_heads, cfg.context_dim,
                                      depth=cfg.transformer_depth,
                                      attn_impl=cfg.attn_impl, quant=cfg.quant, **kw)

        self.time_embed = nn.Sequential(
            Linear(mc, emb_ch, **kw), nn.SiLU(), Linear(emb_ch, emb_ch, **kw))
        self.input_blocks = nn.ModuleList([
            nn.ModuleList([Conv2d(cfg.in_channels, mc, 3, padding=1, **kw)])])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch, **kw)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch, **kw))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(
            GroupNorm32(ch, fuse_silu=cfg.fused_groupnorm, device=device),
            nn.SiLU(),
            Conv2d(ch, cfg.out_channels, 3, padding=1, zero_init=True, **kw))

    def forward(self, x, timesteps, context, cfg_expand: bool = False,
                return_features: bool = False):
        """x: (B, 9, H, W) latent stack; timesteps: (B,); context: (B, T, 768).

        cfg_expand: exact CFG prefix dedup. x and timesteps are ONE half
        batch (B) and context is the CFG pair (2B, uncond first); the stem,
        the first ResBlock and the first self-attention run once at B, and
        the batch doubles at the first context read. Returns eps at 2B.
        Returns fp32; with return_features, (eps, the activations after each
        decoder block), as the landmark auxiliary loss reads them.
        """
        cfg = self.config
        dt = cfg.dtype
        emb = self.time_embed[0](timestep_embedding(timesteps, cfg.model_channels))
        emb = self.time_embed[2](F.silu(emb))
        x = x.to(dt)
        context = context.to(dt)
        expanded = not cfg_expand

        remat = cfg.remat and torch.is_grad_enabled()
        call = (lambda layer, *a, **kw: checkpoint(layer, *a, use_reentrant=False, **kw)) \
            if remat else (lambda layer, *a, **kw: layer(*a, **kw))

        def run(block, h, emb, expanded):
            for layer in block:
                if isinstance(layer, ResBlock):
                    h = call(layer, h, emb)
                elif isinstance(layer, SpatialTransformer):
                    if not expanded:
                        h = call(layer, h, context, expand_cfg=True)
                        expanded = True
                        emb = torch.cat([emb, emb], dim=0)
                    else:
                        h = call(layer, h, context)
                else:
                    h = layer(h)
            return h, emb, expanded

        h = self.input_blocks[0][0](x)
        hs = [h]
        for block in self.input_blocks[1:]:
            h, emb, expanded = run(block, h, emb, expanded)
            hs.append(h)
        if not expanded:  # no attention layer reached (degenerate config)
            h = torch.cat([h, h], dim=0)
            emb = torch.cat([emb, emb], dim=0)
            expanded = True
        h, emb, expanded = run(self.middle_block, h, emb, expanded)
        features = []
        for block in self.output_blocks:
            skip = hs.pop()
            if skip.shape[0] != h.shape[0]:
                # saved before the CFG expansion point (shared half)
                skip = torch.cat([skip, skip], dim=0)
            h, emb, expanded = run(block, torch.cat([h, skip], dim=1), emb, expanded)
            features.append(h)
        h = self.out[0](h)
        if not cfg.fused_groupnorm:
            h = F.silu(h)
        out = self.out[2](h).float()
        return (out, features) if return_features else out
