"""AutoencoderKL, the frozen SD-v1 VAE (port of reface_tpu/nn/vae.py), NCHW.

Module names are the reference torch checkpoint's (ldm model.py), e.g.
`encoder.down.0.block.0.conv1.weight`, so `first_stage_model.*` of a REFace
`last.ckpt` loads as it is. The mid-block AttnBlock (one head, d=512, over
4096 tokens at 512 px) runs kernel K2 on the card through the attention
dispatch; with VAEConfig.remat (training through the decoder) the decoder's
runs the differentiable FlashAttention instead (the residual K2 forward,
K4/K5 in the backward). The 0.18215 latent scale is applied by the caller.
VAEConfig.quant "int8" or "int8conv" (the same here: the VAE has no dense
site) runs the ResnetBlocks' conv1, conv2 and nin_shortcut int8
(ops/quant.py); the mid-block attention, stem, head and up/downsampling
stay in the compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from reface_tpu_torch.core.distributions import DiagonalGaussian
from reface_tpu_torch.nn.layers import Conv2d, GroupNorm32, Upsample, check_quant
from reface_tpu_torch.ops.attention import multi_head_attention

__all__ = ["VAEConfig", "Encoder", "Decoder", "AutoencoderKL", "AttnBlock",
           "SD_SCALE_FACTOR"]

SD_SCALE_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    out_ch: int = 3
    double_z: bool = True
    dtype: torch.dtype = torch.bfloat16
    # built for a backward through the decoder (the full training loss):
    # the decoder's ResnetBlocks and Upsamples are recomputed in the backward
    # and its attention is the differentiable FlashAttention
    remat: bool = False
    # "none" | "int8" | "int8conv" (module docstring)
    quant: str = "none"


class ResnetBlock(nn.Module):
    def __init__(self, channels: int, out_channels: int, dtype=torch.float32,
                 quant: str = "none", device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, quant=quant)
        self.norm1 = GroupNorm32(channels, eps=1e-6, device=device)
        self.conv1 = Conv2d(channels, out_channels, 3, padding=1, **kw)
        self.norm2 = GroupNorm32(out_channels, eps=1e-6, device=device)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, **kw)
        if channels != out_channels:
            self.nin_shortcut = Conv2d(channels, out_channels, 1, **kw)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention with 1x1-conv projections.

    attn_impl: "auto" (K2 on the card, no backward) or "flash" (the
    differentiable FlashAttention), ops/attention.py's routing. It is fixed
    when the block is built and never read from the autograd state, so a
    checkpointed caller launches the same kernel in its first pass and in
    its recomputation."""

    def __init__(self, channels: int, dtype=torch.float32, device=None,
                 attn_impl: str = "auto"):
        super().__init__()
        self.attn_impl = attn_impl
        kw = dict(dtype=dtype, device=device)
        self.norm = GroupNorm32(channels, eps=1e-6, device=device)
        self.q = Conv2d(channels, channels, 1, **kw)
        self.k = Conv2d(channels, channels, 1, **kw)
        self.v = Conv2d(channels, channels, 1, **kw)
        self.proj_out = Conv2d(channels, channels, 1, **kw)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        tokens = lambda t: t.reshape(b, c, hh * ww).transpose(1, 2)
        o = multi_head_attention(tokens(self.q(h)), tokens(self.k(h)),
                                 tokens(self.v(h)), num_heads=1,
                                 impl=self.attn_impl)
        return x + self.proj_out(o.transpose(1, 2).reshape(b, c, hh, ww))


class Downsample(nn.Module):
    """Stride-2 conv with SD's asymmetric (0,1)x(0,1) padding."""

    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, dtype=dtype,
                           device=device)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def _mid(ch, kw, quant: str, attn_impl: str = "auto"):
    mid = nn.Module()
    mid.block_1 = ResnetBlock(ch, ch, quant=quant, **kw)
    mid.attn_1 = AttnBlock(ch, attn_impl=attn_impl, **kw)
    mid.block_2 = ResnetBlock(ch, ch, quant=quant, **kw)
    return mid


def _run_mid(mid, h, call=lambda layer, x: layer(x)):
    return call(mid.block_2, mid.attn_1(call(mid.block_1, h)))


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig(), device=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=cfg.dtype, device=device)
        self.conv_in = Conv2d(3, cfg.ch, 3, padding=1, **kw)
        self.down = nn.ModuleList()
        block_in = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(block_in, cfg.ch * mult,
                                               quant=cfg.quant, **kw))
                block_in = cfg.ch * mult
            if i != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(block_in, **kw)
            self.down.append(level)
        self.mid = _mid(block_in, kw, cfg.quant)
        self.norm_out = GroupNorm32(block_in, eps=1e-6, device=device)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1, **kw)

    def forward(self, x):
        h = self.conv_in(x.to(self.config.dtype))
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = _run_mid(self.mid, h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig(), device=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=cfg.dtype, device=device)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, block_in, 3, padding=1, **kw)
        self.mid = _mid(block_in, kw, cfg.quant,
                        attn_impl="flash" if cfg.remat else "auto")
        levels = [None] * len(cfg.ch_mult)
        for i in reversed(range(len(cfg.ch_mult))):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, cfg.ch * cfg.ch_mult[i],
                                               quant=cfg.quant, **kw))
                block_in = cfg.ch * cfg.ch_mult[i]
            if i != 0:
                level.upsample = Upsample(block_in, **kw)
            levels[i] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(block_in, eps=1e-6, device=device)
        self.conv_out = Conv2d(block_in, cfg.out_ch, 3, padding=1, **kw)

    def forward(self, z):
        # per-block remat, while gradients are recorded (as nn/unet.py)
        remat = self.config.remat and torch.is_grad_enabled()
        call = (lambda layer, x: checkpoint(layer, x, use_reentrant=False)) \
            if remat else (lambda layer, x: layer(x))
        h = self.conv_in(z.to(self.config.dtype))
        h = _run_mid(self.mid, h, call)
        for level in reversed(self.up):
            for blk in level.block:
                h = call(blk, h)
            if hasattr(level, "upsample"):
                h = call(level.upsample, h)
        return self.conv_out(F.silu(self.norm_out(h))).float()


class AutoencoderKL(nn.Module):
    """encode(x) -> DiagonalGaussian over 4-ch latents; decode(z) -> image."""

    def __init__(self, config: VAEConfig = VAEConfig(), device=None):
        super().__init__()
        check_quant(config.quant)
        self.config = config
        self.encoder = Encoder(config, device=device)
        self.decoder = Decoder(config, device=device)
        zc = 2 * config.embed_dim if config.double_z else config.embed_dim
        zin = 2 * config.z_channels if config.double_z else config.z_channels
        kw = dict(dtype=config.dtype, device=device)
        self.quant_conv = Conv2d(zin, zc, 1, **kw)
        self.post_quant_conv = Conv2d(config.embed_dim, config.z_channels, 1, **kw)

    def encode(self, x) -> DiagonalGaussian:
        moments = self.quant_conv(self.encoder(x)).float()
        return DiagonalGaussian.from_moments(moments, dim=1)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))
