"""Shared building blocks (port of reface_tpu/nn/layers.py), NCHW.

Dtype policy, as in the JAX package: each Linear/Conv computes in its
module's `dtype` (bf16 by default) and keeps its weight and bias in
`param_dtype`, casting them and the input to `dtype` at each use (flax's
dtype/param_dtype split). param_dtype defaults to `dtype`: serving stores
bf16 weights, which is the same arithmetic as the JAX package's fp32 params
cast at each use; training builds the modules it updates with fp32 weights
(pipelines/train.py), as flax keeps them, so that AdamW's small updates are
not lost to bf16 rounding. Norms keep fp32 params and compute in fp32:
GroupNorm32 returns the input dtype, LayerNorm returns the dtype it is built
with.

Parameter names follow the reference torch checkpoints, so a state_dict of
the reference loads as it is (e.g. `to_out.0.weight`, `ff.net.0.proj.bias`).

Int8 serving modes (`quant`, ops/quant.py), the JAX package's QDense and
QConv sites: a Linear built with quant="int8" and a Conv2d built with
"int8" or "int8conv" run their product int8 x int8 -> int32 and
dequantise into `dtype`; "none" is the plain product. The weight is
quantised from the stored weight (bf16 in serving, where the JAX package
quantises its fp32 params) and kept until it changes. The parameters and
their names are the same in every mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reface_tpu_torch.ops.attention import multi_head_attention
from reface_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
from reface_tpu_torch.ops.quant import (
    QUANT_MODES,
    cached_weight,
    conv_weight_q,
    int8_conv_q,
    int8_dense_q,
    quant_int8,
)

__all__ = ["Linear", "Conv2d", "GroupNorm32", "LayerNorm", "CrossAttention",
           "FeedForwardGEGLU", "Upsample", "check_quant"]


def check_quant(quant: str) -> None:
    """Raise ValueError unless `quant` names a mode: "none", "int8" (every
    dense and conv site) or "int8conv" (the conv sites only)."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant={quant!r}: expected one of {QUANT_MODES}")


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """nn.Linear computing in `dtype` with its weight and bias stored in
    `param_dtype` (default `dtype`); a QDense site: quant="int8" runs the
    int8 product (int8_dense, from the un-cast input), "int8conv" and
    "none" the plain one."""

    def __init__(self, in_features, out_features, bias=True,
                 dtype=torch.float32, param_dtype=None, device=None,
                 quant: str = "none"):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype or dtype)
        check_quant(quant)
        self.compute_dtype = dtype
        self.int8 = quant == "int8"

    def forward(self, x):
        dt = self.compute_dtype
        if self.int8:
            wq = cached_weight(self, lambda w: quant_int8(w, dim=1))
            y = int8_dense_q(x, *wq, out_dtype=dt)
            return y if self.bias is None else y + self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `dtype` with its weight and bias stored in
    `param_dtype` (default `dtype`); a QConv site (stride 1, square kernel):
    quant "int8" or "int8conv" runs the int8 product (int8_conv, from the
    un-cast input).

    zero_init marks the layers the reference zero-initialises (ResBlock and
    UNet output convs, SpatialTransformer.proj_out); pipelines/swap.py's
    init_params reads it.
    """

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 bias=True, dtype=torch.float32, param_dtype=None, device=None,
                 zero_init: bool = False, quant: str = "none"):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, bias=bias, dtype=param_dtype or dtype,
                         device=device)
        check_quant(quant)
        self.compute_dtype = dtype
        self.zero_init = zero_init
        self.int8 = quant != "none"
        if self.int8 and (stride != 1 or self.kernel_size[0] != self.kernel_size[1]):
            raise ValueError("an int8 Conv2d takes stride 1 and a square kernel")

    def forward(self, x):
        dt = self.compute_dtype
        if self.int8:
            wq = cached_weight(self, conv_weight_q)
            y = int8_conv_q(x, *wq, self.kernel_size[0], self.padding[0], out_dtype=dt)
            return y if self.bias is None else y + self.bias.to(dt)[:, None, None]
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class GroupNorm32(nn.Module):
    """GroupNorm (32 groups unless num_groups says otherwise) in fp32 whatever
    the input dtype; returns the input dtype.

    fuse_silu=True returns SiLU(GroupNorm(x)) through kernel K3
    (ops/groupnorm.py) on the card; callers then skip their own SiLU.
    """

    def __init__(self, channels: int, eps: float = 1e-5, fuse_silu: bool = False,
                 num_groups: int = 32, device=None):
        super().__init__()
        self.groups = min(num_groups, channels)  # tiny test configs
        self.eps = eps
        self.fuse_silu = fuse_silu
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        if self.fuse_silu:
            # K3 takes contiguous NCHW; a conv fed a transposed view (the
            # SpatialTransformer's proj_out) may hand back channels-last
            return group_norm_silu(x.contiguous(), self.weight, self.bias,
                                   self.groups, self.eps, silu=True)
        return group_norm_silu_plain(x, self.weight, self.bias, self.groups,
                                     self.eps, silu=False)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 and returned in `out_dtype` (flax's
    LayerNorm(dtype=...) semantics); its weight and bias are taken in fp32
    whatever their storage dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, out_dtype=torch.float32,
                 device=None):
        super().__init__(dim, eps=eps, device=device)
        self.out_dtype = out_dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, _cast(self.weight, torch.float32),
                            _cast(self.bias, torch.float32), self.eps).to(self.out_dtype)


class Upsample(nn.Module):
    """Nearest 2x upsample then a 3x3 conv (the UNet's and the VAE's)."""

    def __init__(self, channels: int, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype,
                           param_dtype=param_dtype, device=device)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class CrossAttention(nn.Module):
    """Q from x, K/V from context (self-attention when context is None).

    Parity: reface_tpu/nn/layers.py CrossAttention, including the 1536-d
    split context that routes CLIP/ID features to heads [:6] and landmark
    features to heads [6:] (head_splits=(6, 2)), and the exact single-token
    context shortcut.
    """

    def __init__(self, query_dim: int, context_dim: int | None = None,
                 heads: int = 8, dim_head: int = 64, head_splits=(6, 2),
                 dtype=torch.float32, param_dtype=None, attn_impl: str = "auto",
                 quant: str = "none", device=None):
        """quant="int8" quantises a self-attention's projections (to_q, to_k,
        to_v, to_out); a cross-attention (context_dim given) stays plain,
        as in the JAX package. The JAX package's int8 self-attention runs
        one product against the concatenated q/k/v weight; three separate
        products are the same numbers, since the activation scale is per
        row and the weight scales per output column."""
        super().__init__()
        check_quant(quant)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self_kw = dict(kw, quant="none" if context_dim else quant)
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads, self.dim_head, self.inner = heads, dim_head, inner
        self.ctx_dim = ctx_dim
        self.head_splits = head_splits
        self.attn_impl = attn_impl
        self.to_q = Linear(query_dim, inner, bias=False, **self_kw)
        self.to_k = Linear(ctx_dim, inner, bias=False, **self_kw)
        self.to_v = Linear(ctx_dim, inner, bias=False, **self_kw)
        self.to_out = nn.Sequential(Linear(inner, query_dim, **self_kw), nn.Identity())

    def _split_context(self, proj, ctx):
        """Project a 2*ctx_dim split context: heads[:s0] from the first half,
        the last s1 heads from the second."""
        c1, c2 = torch.chunk(ctx, 2, dim=-1)
        s0 = self.head_splits[0] * self.dim_head
        s1 = self.head_splits[1] * self.dim_head
        return torch.cat([proj(c1)[..., :s0], proj(c2)[..., self.inner - s1:]], -1)

    def forward(self, x, context=None):
        if context is None:
            out = multi_head_attention(self.to_q(x), self.to_k(x), self.to_v(x),
                                       self.heads, impl=self.attn_impl)
            return self.to_out[0](out)

        split = context.shape[-1] == 2 * self.ctx_dim
        if context.shape[-2] == 1:
            # softmax over one key is identically 1: the output is V's
            # projection broadcast over the queries (exact)
            v = self._split_context(self.to_v, context) if split else self.to_v(context)
            out1 = self.to_out[0](v)
            return out1.expand(*x.shape[:-1], out1.shape[-1])

        q = self.to_q(x)
        if split:
            k = self._split_context(self.to_k, context)
            v = self._split_context(self.to_v, context)
        else:
            k, v = self.to_k(context), self.to_v(context)
        out = multi_head_attention(q, k, v, self.heads, impl=self.attn_impl)
        return self.to_out[0](out)


class _GEGLUProj(nn.Module):
    def __init__(self, dim, inner, kw):
        super().__init__()
        self.proj = Linear(dim, inner * 2, **kw)


class FeedForwardGEGLU(nn.Module):
    """GEGLU feed-forward: proj to 2*4d, gate with gelu, project back.

    The gate uses the tanh-approximate gelu, as the JAX package's flax
    nn.gelu default does (ROADMAP section C logs the question). Both
    projections are QDense sites (quant="int8").
    """

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32,
                 param_dtype=None, quant: str = "none", device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device, quant=quant)
        inner = dim * mult
        self.net = nn.ModuleList([
            _GEGLUProj(dim, inner, kw),
            nn.Identity(),
            Linear(inner, dim, **kw),
        ])

    def forward(self, x):
        h, gate = torch.chunk(self.net[0].proj(x), 2, dim=-1)
        return self.net[2](h * F.gelu(gate, approximate="tanh"))
