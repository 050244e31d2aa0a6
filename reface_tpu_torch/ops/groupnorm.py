"""GroupNorm(+SiLU) over NCHW (kernel K3; port of reface_tpu/ops/groupnorm.py).

On a CUDA tensor `group_norm_silu` launches csrc/groupnorm.cu (a split
reduction, then one apply pass); on a CPU tensor it computes the plain
two-pass version, `group_norm_silu_plain`, the semantics of
reface_tpu/ops/groupnorm.py:_reference_impl. Statistics are fp32; the
output comes back in the input dtype.
"""

from __future__ import annotations

import torch

from reface_tpu_torch.ops import kernels

__all__ = ["group_norm_silu", "group_norm_silu_plain"]


def group_norm_silu_plain(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                          silu: bool = True):
    """NCHW GroupNorm with two-pass fp32 statistics (+SiLU). Returns x.dtype."""
    b, c = x.shape[:2]
    x32 = x.float().reshape(b, groups, -1)
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * scale.float().reshape(shape) + bias.float().reshape(shape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_silu(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                    silu: bool = True):
    """NCHW GroupNorm (+SiLU). scale/bias: (C,) fp32. Returns x.dtype.

    CUDA: x must be contiguous (B, C, H, W) in float32 or bfloat16 with
    C % groups == 0 and H*W % 8 == 0. The kernel has no backward (nor has
    the TPU kernel): on a CUDA tensor that requires grad it raises.
    """
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, scale, bias, groups, eps, silu)
    kernels.refuse_grad("group_norm_silu", "differentiate through the unfused "
                        "GroupNorm (fused_groupnorm=False)", x, scale, bias)
    if not x.is_cuda or x.dtype not in kernels.DTYPE_CODE or x.dim() != 4 \
            or not x.is_contiguous():
        raise ValueError("group_norm_silu: x must be a contiguous NCHW "
                         f"float32/bfloat16 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, c, h, w = x.shape
    if c % groups or (h * w) % 8 or x.data_ptr() % 16:
        raise ValueError(f"group_norm_silu: needs C % groups == 0, H*W % 8 "
                         f"== 0 and 16-byte alignment, got {tuple(x.shape)}")
    for p in (scale, bias):
        if p.dtype != torch.float32 or p.shape != (c,) or p.device != x.device \
                or not p.is_contiguous():
            raise ValueError("group_norm_silu: scale and bias must be (C,) "
                             "float32 on x's device")
    lib = kernels.library("groupnorm")
    part = torch.empty(b * groups * lib.reface_group_norm_partials(c, h * w, groups),
                       dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    rc = lib.reface_group_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        part.data_ptr(), b, c, h * w, groups, eps, int(silu),
        kernels.DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "group_norm_silu")
    kernels.count_launch(group_norm_silu, (b, c, h, w))
    return y


group_norm_silu.launches, group_norm_silu.shapes = 0, None
