"""Self-attention for the UNet's small head dims (kernel K1).

Port of reface_tpu/ops/attention_smalld.py. On a CUDA tensor the wrapper
launches the hand-written kernel of csrc/attention_smalld.cu: in bf16 at
D <= 128 the Hopper forward of csrc/attention_fwd_sm90.cuh with K1's rules,
which streams K/V tiles (a whole head's K and V do not fit a block's shared
memory the way they fit the TPU's VMEM). On a CPU tensor it computes
`einsum_attention`, which is what the JAX package runs off the TPU
(reface_tpu/ops/attention.py:96-101).

The TPU kernel's function, which bf16 K1 computes and `smalld_attention_plain`
writes out: fp32 scores scaled into log2 units; one fixed shift per row,
the max over its first 256 keys (none with `fast`); p = exp2(s - shift)
rounded to the input dtype; the row sum over those rounded p (the kernel's
ones-column) and the PV product, both accumulated in fp32; o = PV / sum in
q's dtype. einsum_attention rounds normalised fp32 weights instead: the two
agree to the rounding of p, not bit for bit.
"""

from __future__ import annotations

import math

import torch

from reface_tpu_torch.ops import kernels

__all__ = ["einsum_attention", "smalld_attention_plain", "self_attention_smalld",
           "check_operands"]

_LOG2E = math.log2(math.e)  # the kernels take the scale in log2 units
_SHIFT_KEYS = 256  # K1's row shift spans the scores of the first 256 keys
# the differentiable attention, named when a kernel without a backward is
# asked for a gradient
_GRAD_ROUTE = ('differentiate through attn_impl="flash" (ops/attention.py '
               'FlashAttention) or "einsum"')


def einsum_attention(q, k, v, scale: float):
    """Plain fp32-softmax attention over (..., N, D) x (..., M, D).

    Semantics of reface_tpu/ops/attention.py:_einsum_attention: fp32 logits,
    fp32 softmax, weights cast to v's dtype, PV product in v's dtype.
    """
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w, v)


def smalld_attention_plain(q, k, v, scale: float, fast: bool = False):
    """K1's plain version, of the TPU smalld kernel's own function
    (reface_tpu/ops/attention_smalld.py:_kernel and _kernel_tn): the fixed
    first-256-key shift (none when `fast`), p rounded to v's dtype in both
    the row sum and the PV product, fp32 accumulation. (..., N, D) x
    (..., M, D) -> (..., N, D) in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * _LOG2E)
    if not fast:
        s = s - s[..., :_SHIFT_KEYS].amax(-1, keepdim=True)
    p = torch.exp2(s).to(v.dtype).float()
    return (torch.matmul(p, v.float()) / p.sum(-1, keepdim=True)).to(q.dtype)


def check_operands(q, k, v, what: str) -> None:
    """Raise on operands the attention kernels do not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what}: q, k, v must all be CUDA tensors")
    if q.dtype not in kernels.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: dtype must be float32 or bfloat16 for all "
                        f"of q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"{what}: expected (BH,N,D), (BH,M,D), (BH,M,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and "
                             "16-byte aligned")


def self_attention_smalld(q, k, v, scale: float | None = None,
                          fast: bool = False):
    """(BH, N, D) self-attention. Returns (BH, N, D) in q.dtype.

    CUDA: the K1 kernel (`smalld_attention_plain`'s function in bf16 at
    D <= 128); D must be a multiple of 8 and at most 256, N == M. fast=True
    drops the softmax shift (serving mode). The kernel has no backward: on a
    CUDA tensor that requires grad it raises. CPU: `einsum_attention`, the
    JAX package's off-TPU route (exact whatever `fast` says).
    """
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    if q.device.type == "cpu":
        return einsum_attention(q, k, v, scale)
    kernels.refuse_grad("self_attention_smalld", _GRAD_ROUTE, q, k, v)
    check_operands(q, k, v, "self_attention_smalld")
    bh, n, _ = q.shape
    if k.shape[1] != n or d % 8 or d > 256:
        raise ValueError("self_attention_smalld: needs N == M and D a "
                         f"multiple of 8 up to 256, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    out = torch.empty_like(q)
    lib = kernels.library("attention_smalld")
    rc = lib.reface_smalld_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, n, d,
        scale * _LOG2E, int(fast), kernels.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "self_attention_smalld")
    kernels.count_launch(self_attention_smalld, (bh, n, d))
    return out


self_attention_smalld.launches, self_attention_smalld.shapes = 0, None
