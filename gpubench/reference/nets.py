"""Plain fp32 PyTorch of the REFace towers: the benchmark's reference.

The equations of the SD v1-4 9-channel UNet, the kl-f8 VAE, CLIP ViT-L/14
with the REFace mapper head, IR-SE-50, the conditioning fusion and LPIPS
(AlexNet), written out with torch.nn.functional and nothing else. The
parameter names are the REFace checkpoint's, which the measured program
uses too, so one state dict loads both.

Departures from the published modules, all of form: attention is computed
in blocks of query rows (`attention`), each block an fp32 softmax over all
keys; remat=True recomputes each UNet ResBlock and SpatialTransformer and
each VAE decoder block in the backward (torch.utils.checkpoint), which
changes memory and not values. `set_fake_fp8` rounds the inputs of every
product to fp8 (e4m3, one scale per tensor): the lower-precision control.

This file imports neither the measured program nor JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# query rows of one attention block: 1024 rows x 4096 keys x 8 heads of
# fp32 scores is 128 MiB a sample
ATTN_BLOCK = 1024
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
ARC_FACE_CROP = (35, 223, 32, 220)  # (top, bottom, left, right) on the 256 px pool
SD_SCALE_FACTOR = 0.18215


class _RoundFp8(torch.autograd.Function):
    """x rounded to float8_e4m3fn at the scale that maps max|x| to 448;
    the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


def _q(module, t):
    return _RoundFp8.apply(t) if module.fake_fp8 else t


class Linear(nn.Linear):
    fake_fp8 = False

    def forward(self, x):
        return F.linear(_q(self, x), _q(self, self.weight), self.bias)


class Conv2d(nn.Conv2d):
    fake_fp8 = False

    def forward(self, x):
        return self._conv_forward(_q(self, x), _q(self, self.weight), self.bias)


def set_fake_fp8(module: nn.Module) -> nn.Module:
    """Round the operands of every Linear and Conv2d product to fp8."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d)):
            m.fake_fp8 = True
    return module


class GroupNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5, groups: int = 32):
        super().__init__()
        self.groups, self.eps = min(groups, channels), eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)


class LayerNorm(nn.LayerNorm):
    pass


def attention(q, k, v, heads: int):
    """(B, N, H*D) x (B, M, H*D) -> (B, N, H*D): softmax(q k^T / sqrt(D)) v
    per head, in blocks of ATTN_BLOCK query rows."""
    b, n, inner = q.shape
    m, d = k.shape[1], inner // heads
    split = lambda t, rows: t.reshape(b, rows, heads, d).transpose(1, 2)
    qh, kh, vh = split(q, n), split(k, m), split(v, m)
    out = []
    for lo in range(0, n, ATTN_BLOCK):
        s = torch.matmul(qh[:, :, lo:lo + ATTN_BLOCK], kh.transpose(-1, -2)) * d**-0.5
        out.append(torch.matmul(torch.softmax(s, dim=-1), vh))
    return torch.cat(out, dim=2).transpose(1, 2).reshape(b, n, inner)


# ------------------------------------------------------------------ UNet

def timestep_embedding(t, dim: int, max_period: int = 10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm(cin), nn.SiLU(), Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb, cout))
        self.out_layers = nn.Sequential(GroupNorm(cout), nn.SiLU(), nn.Identity(),
                                        Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = nn.Identity() if cin == cout else Conv2d(cin, cout, 1)

    def forward(self, x, emb):
        h = self.in_layers[2](F.silu(self.in_layers[0](x)))
        h = h + self.emb_layers[1](F.silu(emb))[:, :, None, None]
        h = self.out_layers[3](F.silu(self.out_layers[0](h)))
        return self.skip_connection(x) + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int | None = None):
        super().__init__()
        self.heads = heads
        ctx = context_dim or dim
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(ctx, dim, bias=False)
        self.to_v = Linear(ctx, dim, bias=False)
        self.to_out = nn.Sequential(Linear(dim, dim), nn.Identity())

    def forward(self, x, context=None):
        c = x if context is None else context
        if c.shape[1] == 1:
            # softmax over a single key is 1: each query's output is that
            # key's value (REFace's context is one token)
            return self.to_out[0](self.to_v(c)).expand(x.shape[0], x.shape[1], -1)
        return self.to_out[0](attention(self.to_q(x), self.to_k(c), self.to_v(c), self.heads))


class _GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, inner * 2)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([_GEGLU(dim, dim * mult), nn.Identity(), Linear(dim * mult, dim)])

    def forward(self, x):
        h, gate = torch.chunk(self.net[0].proj(x), 2, dim=-1)
        # the tanh-approximate gelu of the JAX package (flax's nn.gelu default)
        return self.net[2](h * F.gelu(gate, approximate="tanh"))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, context_dim)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, heads: int, context_dim: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNorm(ch, eps=1e-6)
        self.proj_in = Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, heads, context_dim) for _ in range(depth)])
        self.proj_out = Conv2d(ch, ch, 1)

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x)).reshape(b, c, hh * ww).transpose(1, 2)
        for blk in self.transformer_blocks:
            h = blk(h, context)
        return x + self.proj_out(h.transpose(1, 2).reshape(b, c, hh, ww))


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet(nn.Module):
    """cfg: in_channels, out_channels, model_channels, num_res_blocks,
    attention_resolutions, channel_mult, num_heads, transformer_depth,
    context_dim (the configuration file's "unet" group)."""

    def __init__(self, cfg: dict, remat: bool = False):
        super().__init__()
        self.cfg, self.remat = cfg, remat
        mc, heads, ctx = cfg["model_channels"], cfg["num_heads"], cfg["context_dim"]
        depth, nres = cfg["transformer_depth"], cfg["num_res_blocks"]
        emb = 4 * mc
        self.time_embed = nn.Sequential(Linear(mc, emb), nn.SiLU(), Linear(emb, emb))
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(cfg["in_channels"], mc, 3, padding=1)])])
        chans, ch, ds = [mc], mc, 1
        mults = cfg["channel_mult"]
        for level, mult in enumerate(mults):
            for _ in range(nres):
                layers = [ResBlock(ch, mult * mc, emb)]
                ch = mult * mc
                if ds in cfg["attention_resolutions"]:
                    layers.append(SpatialTransformer(ch, heads, ctx, depth))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(mults) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb), SpatialTransformer(ch, heads, ctx, depth),
                                           ResBlock(ch, ch, emb)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(mults))):
            for i in range(nres + 1):
                layers = [ResBlock(ch + chans.pop(), mult * mc, emb)]
                ch = mult * mc
                if ds in cfg["attention_resolutions"]:
                    layers.append(SpatialTransformer(ch, heads, ctx, depth))
                if level and i == nres:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm(ch), nn.SiLU(), Conv2d(ch, cfg["out_channels"], 3, padding=1))

    def _call(self, layer, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def _run(self, block, h, emb, context):
        for layer in block:
            if isinstance(layer, ResBlock):
                h = self._call(layer, h, emb)
            elif isinstance(layer, SpatialTransformer):
                h = self._call(layer, h, context)
            else:
                h = layer(h)
        return h

    def forward(self, x, t, context):
        emb = self.time_embed[2](F.silu(self.time_embed[0](
            timestep_embedding(t, self.cfg["model_channels"]))))
        h = self.input_blocks[0][0](x)
        hs = [h]
        for block in self.input_blocks[1:]:
            h = self._run(block, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out[2](F.silu(self.out[0](h)))


# ------------------------------------------------------------------ VAE

class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(cin, eps=1e-6), Conv2d(cin, cout, 3, padding=1)
        self.norm2, self.conv2 = GroupNorm(cout, eps=1e-6), Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class AttnBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm(ch, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (Conv2d(ch, ch, 1) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        tok = lambda t: t.reshape(b, c, hh * ww).transpose(1, 2)
        o = attention(tok(self.q(h)), tok(self.k(h)), tok(self.v(h)), 1)
        return x + self.proj_out(o.transpose(1, 2).reshape(b, c, hh, ww))


class VAEDownsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def _mid(ch):
    mid = nn.Module()
    mid.block_1, mid.attn_1, mid.block_2 = ResnetBlock(ch, ch), AttnBlock(ch), ResnetBlock(ch, ch)
    return mid


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, mults, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
        self.conv_in = Conv2d(3, ch, 3, padding=1)
        self.down = nn.ModuleList()
        cin = ch
        for i, mult in enumerate(mults):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(nres):
                level.block.append(ResnetBlock(cin, ch * mult))
                cin = ch * mult
            if i != len(mults) - 1:
                level.downsample = VAEDownsample(cin)
            self.down.append(level)
        self.mid = _mid(cin)
        self.norm_out = GroupNorm(cin, eps=1e-6)
        self.conv_out = Conv2d(cin, 2 * cfg["z_channels"], 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: dict, remat: bool = False):
        super().__init__()
        self.remat = remat
        ch, mults, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
        cin = ch * mults[-1]
        self.conv_in = Conv2d(cfg["z_channels"], cin, 3, padding=1)
        self.mid = _mid(cin)
        levels = [None] * len(mults)
        for i in reversed(range(len(mults))):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(nres + 1):
                level.block.append(ResnetBlock(cin, ch * mults[i]))
                cin = ch * mults[i]
            if i != 0:
                level.upsample = Upsample(cin)
            levels[i] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(cin, eps=1e-6)
        self.conv_out = Conv2d(cin, 3, 3, padding=1)

    def forward(self, z):
        remat = self.remat and torch.is_grad_enabled()
        call = (lambda f, x: checkpoint(f, x, use_reentrant=False)) if remat else (lambda f, x: f(x))
        h = self.conv_in(z)
        h = call(self.mid.block_2, self.mid.attn_1(call(self.mid.block_1, h)))
        for level in reversed(self.up):
            for blk in level.block:
                h = call(blk, h)
            if hasattr(level, "upsample"):
                h = call(level.upsample, h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """cfg: ch, ch_mult, num_res_blocks, z_channels, embed_dim."""

    def __init__(self, cfg: dict, remat: bool = False):
        super().__init__()
        self.encoder, self.decoder = Encoder(cfg), Decoder(cfg, remat)
        self.quant_conv = Conv2d(2 * cfg["z_channels"], 2 * cfg["embed_dim"], 1)
        self.post_quant_conv = Conv2d(cfg["embed_dim"], cfg["z_channels"], 1)

    def posterior(self, x):
        """(mean, std) of the latent posterior, logvar clamped to [-30, 20]."""
        mean, logvar = torch.chunk(self.quant_conv(self.encoder(x)), 2, dim=1)
        return mean, torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


# ------------------------------------------------------------------ CLIP and the mapper

class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(hidden, hidden) for _ in range(4))

    def forward(self, x):
        return self.out_proj(attention(self.q_proj(x), self.k_proj(x), self.v_proj(x), self.heads))


class _MLP(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.fc1, self.fc2 = Linear(hidden, 4 * hidden), Linear(4 * hidden, hidden)


class CLIPLayer(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm1, self.layer_norm2 = LayerNorm(hidden), LayerNorm(hidden)
        self.mlp = _MLP(hidden)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))  # quick gelu


class CLIPVision(nn.Module):
    """cfg: hidden, layers, heads, patch, image_size, projection_dim."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        hidden = cfg["hidden"]
        vm = self.vision_model = nn.Module()
        vm.embeddings = nn.Module()
        vm.embeddings.class_embedding = nn.Parameter(torch.zeros(hidden))
        vm.embeddings.patch_embedding = Conv2d(3, hidden, cfg["patch"], stride=cfg["patch"], bias=False)
        tokens = (cfg["image_size"] // cfg["patch"]) ** 2 + 1
        vm.embeddings.position_embedding = nn.Embedding(tokens, hidden)
        vm.pre_layrnorm = LayerNorm(hidden)
        vm.encoder = nn.Module()
        vm.encoder.layers = nn.ModuleList([CLIPLayer(hidden, cfg["heads"]) for _ in range(cfg["layers"])])
        vm.post_layernorm = LayerNorm(hidden)
        self.visual_projection = Linear(hidden, cfg["projection_dim"], bias=False)

    def forward(self, x):
        emb = self.vision_model.embeddings
        patches = emb.patch_embedding(x).flatten(2).transpose(1, 2)
        cls = emb.class_embedding.expand(x.shape[0], 1, -1)
        h = torch.cat([cls, patches], dim=1) + emb.position_embedding.weight[None]
        h = self.vision_model.pre_layrnorm(h)
        for layer in self.vision_model.encoder.layers:
            h = layer(h)
        return self.visual_projection(self.vision_model.post_layernorm(h[:, 0]))


class _MapperAttention(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.c_qkv, self.c_proj = Linear(width, 3 * width), Linear(width, width)


class _MapperMLP(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.c_fc, self.c_proj = Linear(width, 4 * width), Linear(4 * width, width)


class MapperBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1, self.ln_2 = LayerNorm(width), LayerNorm(width)
        self.attn, self.mlp = _MapperAttention(width), _MapperMLP(width)

    def forward(self, x):
        b, n, w = x.shape
        d = w // self.heads
        qkv = self.attn.c_qkv(self.ln_1(x)).reshape(b, n, self.heads, 3 * d)
        q, k, v = torch.chunk(qkv, 3, dim=-1)  # each head's q, k, v side by side
        flat = lambda t: t.reshape(b, n, w)
        x = x + self.attn.c_proj(attention(flat(q), flat(k), flat(v), self.heads))
        return x + self.mlp.c_proj(F.gelu(self.mlp.c_fc(self.ln_2(x))))


class CLIPConditioner(nn.Module):
    def __init__(self, cfg: dict, mapper_layers: int = 5, width: int = 768):
        super().__init__()
        self.model = CLIPVision(cfg)
        self.mapper2 = nn.Module()
        self.mapper2.resblocks = nn.ModuleList([MapperBlock(width, 1) for _ in range(mapper_layers)])
        self.final_ln2 = LayerNorm(width)

    def forward(self, x):
        z = self.model(x)[:, None, :]
        for blk in self.mapper2.resblocks:
            z = blk(z)
        return self.final_ln2(z)


# ------------------------------------------------------------------ IR-SE-50

class BatchNorm(nn.Module):
    """Inference BatchNorm with torch's parameter and buffer names."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight, self.bias = nn.Parameter(torch.ones(n)), nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class PReLU(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((n,), 0.25))

    def forward(self, x):
        return F.prelu(x, self.weight)


class SEModule(nn.Module):
    def __init__(self, ch: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Conv2d(ch, max(1, ch // reduction), 1, bias=False)
        self.fc2 = Conv2d(max(1, ch // reduction), ch, 1, bias=False)

    def forward(self, x):
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))))


class BottleneckIRSE(nn.Module):
    def __init__(self, cin: int, depth: int, stride: int):
        super().__init__()
        self.shortcut_layer = (nn.MaxPool2d(1, stride) if cin == depth else
                               nn.Sequential(Conv2d(cin, depth, 1, stride=stride, bias=False), BatchNorm(depth)))
        self.res_layer = nn.Sequential(
            BatchNorm(cin), Conv2d(cin, depth, 3, padding=1, bias=False), PReLU(depth),
            Conv2d(depth, depth, 3, stride=stride, padding=1, bias=False), BatchNorm(depth),
            SEModule(depth))

    def forward(self, x):
        return self.res_layer(x) + self.shortcut_layer(x)


class IRSE50(nn.Module):
    """cfg: depths, units, embed_dim. (B,3,112,112) -> l2-normalised (B, embed_dim)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.input_layer = nn.Sequential(Conv2d(3, 64, 3, padding=1, bias=False), BatchNorm(64), PReLU(64))
        blocks, cin = [], 64
        for depth, units in zip(cfg["depths"], cfg["units"]):
            for u in range(units):
                blocks.append(BottleneckIRSE(cin, depth, 2 if u == 0 else 1))
                cin = depth
        self.body = nn.Sequential(*blocks)
        self.output_layer = nn.Sequential(BatchNorm(cin), nn.Identity(), nn.Flatten(),
                                          Linear(cin * 49, cfg["embed_dim"]), BatchNorm(cfg["embed_dim"]))

    def forward(self, x):
        h = self.output_layer(self.body(self.input_layer(x)))
        return h / torch.linalg.vector_norm(h, dim=1, keepdim=True)


def _chw(a, x):
    return torch.tensor(a, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)


def arcface_input(img_pm1):
    """[-1,1] (B,3,S,S) -> the IR-SE-50 input: pool to 256, crop, pool to 112."""
    x = F.adaptive_avg_pool2d(img_pm1, 256)
    top, bottom, left, right = ARC_FACE_CROP
    return F.adaptive_avg_pool2d(x[:, :, top:bottom, left:right], 112)


def clip_to_pm1(x):
    """CLIP-normalised image -> [-1,1]."""
    return (x * _chw(CLIP_STD, x) + _chw(CLIP_MEAN, x)) * 2.0 - 1.0


class Conditioner(nn.Module):
    """The REFace fusion: (clip_w (src_proj(CLIP(src)) + tar_proj(CLIP(tar)))
    + id_w ID_proj(ArcFace(src)) + lm_w lm_proj(landmarks)) / (sum of weights).
    cfg: the configuration's "conditioner", "clip" and "arcface" groups."""

    def __init__(self, cfg: dict):
        super().__init__()
        c = cfg["conditioner"]
        self.w = (c["clip_weight"], c["id_weight"], c["landmark_weight"])
        d = c["context_dim"]
        self.cond_stage_model = CLIPConditioner(cfg["clip"])
        self.face_ID_model = nn.Module()
        self.face_ID_model.facenet = IRSE50(cfg["arcface"])
        proj = cfg["clip"]["projection_dim"]
        self.proj_out_source, self.proj_out_target = Linear(proj, d), Linear(proj, d)
        self.ID_proj_out = Linear(cfg["arcface"]["embed_dim"], d)
        self.landmark_proj_out = Linear(c["landmark_dim"], d)
        self.learnable_vector = nn.Parameter(torch.zeros(1, 1, d))

    def forward(self, ref_clip224, tar_clip224, landmarks):
        b = ref_clip224.shape[0]
        z = self.cond_stage_model(torch.cat([ref_clip224, tar_clip224]))
        c_clip = self.proj_out_source(z[:b]) + self.proj_out_target(z[b:])
        c_id = self.ID_proj_out(self.face_ID_model.facenet(arcface_input(clip_to_pm1(ref_clip224))))
        c_lm = self.landmark_proj_out(landmarks)
        wc, wi, wl = self.w
        return (wc * c_clip + wi * c_id[:, None] + wl * c_lm[:, None]) / (wc + wi + wl)


# ------------------------------------------------------------------ LPIPS (AlexNet)

_ALEX = [(0, 64, 11, 4, 2, False), (3, 192, 5, 1, 2, True), (6, 384, 3, 1, 1, True),
         (8, 256, 3, 1, 1, False), (10, 256, 3, 1, 1, False)]
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = nn.Module()
        self.net.layers = nn.ModuleDict()
        cin = 3
        for idx, ch, k, s, p, _ in _ALEX:
            self.net.layers[str(idx)] = Conv2d(cin, ch, k, stride=s, padding=p)
            cin = ch
        self.lin = nn.ModuleList([nn.Sequential(nn.Identity(), Conv2d(ch, 1, 1, bias=False))
                                  for _, ch, *_ in _ALEX])

    def features(self, x):
        h, out = (x - _chw(_LPIPS_SHIFT, x)) / _chw(_LPIPS_SCALE, x), []
        for idx, _, _, _, _, pool in _ALEX:
            if pool:
                h = F.max_pool2d(h, 3, stride=2)
            h = F.relu(self.net.layers[str(idx)](h))
            out.append(h)
        return out

    def forward(self, x, y):
        unit = lambda f: f / (torch.sqrt(torch.sum(f**2, dim=1, keepdim=True) + 1e-16) + 1e-10)
        total = 0.0
        for lin, a, b in zip(self.lin, self.features(x), self.features(y)):
            total = total + lin[1]((unit(a) - unit(b)) ** 2).mean(dim=(1, 2, 3))
        return total


# ------------------------------------------------------------------ the sampler's tables

def alphas_cumprod(n: int = 1000, start: float = 0.00085, end: float = 0.012) -> np.ndarray:
    """The linear ("scaled linear") DDPM schedule of SD v1, float64."""
    betas = np.linspace(start**0.5, end**0.5, n, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def ddim_tables(steps: int, n: int = 1000):
    """(timesteps, a_t, a_prev), t descending: the uniform DDIM subset with
    the +1 offset, a_prev of the first step acp[0]."""
    acp = alphas_cumprod(n)
    ts = np.minimum(np.arange(0, n, n // steps) + 1, n - 1)
    a = acp[ts]
    a_prev = np.concatenate([[acp[0]], acp[ts[:-1]]])
    return ts[::-1].copy(), a[::-1].copy(), a_prev[::-1].copy()


def ddim_update(x, eps, a_t: float, a_prev: float):
    """eta = 0: x_prev = sqrt(a_prev) pred_x0 + sqrt(1 - a_prev) eps.
    Returns (x_prev, pred_x0)."""
    pred_x0 = (x - math.sqrt(1.0 - a_t) * eps) / math.sqrt(a_t)
    return math.sqrt(a_prev) * pred_x0 + math.sqrt(1.0 - a_prev) * eps, pred_x0


def resize_aa_matrix(n: int, m: int) -> np.ndarray:
    """(m, n) weights of a bilinear n -> m resize that widens its triangle
    kernel by n / m on a shrink (jax.image.resize's "bilinear"), each row
    normalised to sum 1."""
    inv = n / m
    width = max(inv, 1.0)
    sample = (np.arange(m) + 0.5) * inv - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[:, None] - np.arange(n)[None, :]) / width)
    return w / w.sum(axis=1, keepdims=True)


def resize_aa(x, size: int):
    """(B,C,H,W) -> (B,C,size,size) with resize_aa_matrix on both axes."""
    mh = torch.tensor(resize_aa_matrix(x.shape[2], size), dtype=x.dtype, device=x.device)
    mw = torch.tensor(resize_aa_matrix(x.shape[3], size), dtype=x.dtype, device=x.device)
    return torch.matmul(torch.matmul(mh, x), mw.t())


def clip_input(target_pm1):
    """The target in [-1,1] -> its CLIP-normalised 224 px crop."""
    x = resize_aa((target_pm1 + 1.0) / 2.0, 224)
    return (x - _chw(CLIP_MEAN, x)) / _chw(CLIP_STD, x)
