"""GroupNorm(+SiLU) over NCHW (kernel K3; port of reface_tpu/ops/groupnorm.py).

On a CUDA tensor `group_norm_silu` launches csrc/groupnorm.cu once: a
thread-block cluster per group, its slices of the group in the CTAs' shared
memory, the partial statistics merged through distributed shared memory
(`cluster_plan` cuts the group). On a CPU tensor it computes the plain
two-pass version, `group_norm_silu_plain`, the semantics of
reface_tpu/ops/groupnorm.py:_reference_impl. Statistics are fp32; the
output comes back in the input dtype. `group_norm` is the norm without the
SiLU: K3 on the card where autograd records nothing, the plain version
under autograd and on the CPU.
"""

from __future__ import annotations

import functools

import torch

from reface_tpu_torch.core import profiling
from reface_tpu_torch.ops import kernels

__all__ = ["group_norm", "group_norm_silu", "group_norm_silu_plain", "cluster_plan"]

# csrc/groupnorm.cu's kSliceBytes (the shared memory a resident slice may
# take) and the portable cluster size
SLICE_BYTES = 224 * 1024
MAX_CLUSTER = 8
# a group is cut into 1, 2, 4 or 8 slices, until each holds at most this many
# elements or the cluster is full
SLICE_TARGET = 4096


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


@functools.lru_cache(maxsize=None)
def cluster_plan(group_len: int, itemsize: int) -> tuple[int, int, bool]:
    """K3's cut of one group of `group_len` elements (a multiple of 8):
    (CTAs in its cluster, elements in each CTA's slice, whether a slice is
    held in shared memory). Slices are multiples of 8 elements (16 bytes of
    bf16, 32 of fp32); the last may be shorter but is never empty. A group
    whose slices would not fit SLICE_BYTES takes the kernel's streaming
    path, which reads the slice a second time from L2."""
    n = 1
    while n < MAX_CLUSTER and group_len > n * SLICE_TARGET:
        n *= 2
    s = -(-group_len // (8 * n)) * 8
    return n, s, s * itemsize <= SLICE_BYTES


@functools.cache
def _entry():
    return kernels.library("groupnorm").reface_group_norm


def group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5):
    """NCHW GroupNorm without SiLU (GroupNorm32's unfused norm). Returns x.dtype.

    On the card, where autograd records nothing (grad mode off, or neither
    x nor scale nor bias requires grad), K3 computes it in one launch and
    raises where it cannot take x (group_norm_silu's conditions). Under
    autograd, and on the CPU, the plain version does; on the card each such
    call counts as `group_norm_plain` in the open span (core/profiling.py).
    Both routes take two-pass fp32 statistics and an fp32 affine, and round
    once to x.dtype."""
    if not x.is_cuda:
        return group_norm_silu_plain(x, scale, bias, groups, eps, silu=False)
    if not kernels.records_grad(x, scale, bias):
        return group_norm_silu(x.contiguous(), scale, bias, groups, eps, silu=False)
    profiling.count_kernel("group_norm_plain")
    return group_norm_silu_plain(x, scale, bias, groups, eps, silu=False)


def group_norm_silu(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                    silu: bool = True):
    """NCHW GroupNorm (+SiLU). scale/bias: (C,) fp32. Returns x.dtype.

    CUDA: x must be contiguous (B, C, H, W) in float32 or bfloat16 with
    C % groups == 0 and H*W % 8 == 0. The kernel has no backward (nor has
    the TPU kernel): on a CUDA tensor that requires grad it raises.
    """
    if x.is_cpu:
        return group_norm_silu_plain(x, scale, bias, groups, eps, silu)
    kernels.refuse_grad("group_norm_silu", "differentiate through the unfused "
                        "GroupNorm (fused_groupnorm=False)", x, scale, bias)
    code = kernels.DTYPE_CODE.get(x.dtype)
    if code is None or not x.is_cuda or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("group_norm_silu: x must be a contiguous NCHW "
                         f"float32/bfloat16 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, c, h, w = shape = x.shape
    hw = h * w
    ptr = x.data_ptr()
    if c % groups or hw % 8 or ptr % 16:
        raise ValueError(f"group_norm_silu: needs C % groups == 0, H*W % 8 "
                         f"== 0 and 16-byte alignment, got {tuple(shape)}")
    dev = x.get_device()
    for p in (scale, bias):
        if p.dtype != torch.float32 or p.shape != (c,) or p.get_device() != dev \
                or not p.is_contiguous():
            raise ValueError("group_norm_silu: scale and bias must be (C,) "
                             "float32 on x's device")
    n, s, resident = cluster_plan(c // groups * hw, x.element_size())
    y = torch.empty_like(x)
    rc = _entry()(ptr, scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                  b, c, hw, groups, eps, silu, code, n, s, resident,
                  torch._C._cuda_getCurrentRawStream(dev))
    kernels.check(rc, "group_norm_silu")
    kernels.count_launch(group_norm_silu, (b, c, h, w))
    return y


group_norm_silu.launches, group_norm_silu.shapes = 0, None
