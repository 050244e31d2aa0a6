"""Multi-head attention dispatch (port of reface_tpu/ops/attention.py).

Routing, as on the TPU (reface_tpu/ops/attention.py:96-101), with "on the
TPU" read as "on a CUDA tensor":
  - impl "auto"/"fast", self-attention with n == m, n >= 512 and d <= 256
    -> K1 (ops/attention_smalld.py, the UNet at 4096 and 1024 tokens);
  - otherwise, n >= 1024 and m >= 128: impl "flash" -> `FlashAttention`, the
    differentiable flash attention that training uses (the residual K2
    forward, then K4/K5 in the backward: the UNet's self-attention, and the
    VAE decoder's mid-block when the recon loss differentiates through it);
    "auto"/"fast" -> K2, `wide_attention` (the VAE mid-block in serving and
    in the encodes: one head of d=512 over 4096 tokens);
  - otherwise the plain fp32-softmax product with autograd, which is the JAX
    package's own choice for small n (the UNet at 256 and 64 tokens), not a
    fallback.
impl="fast" is K1's shift-free serving mode; impl="einsum" forces the plain
product. K1 and K2 have no backward: asked for a gradient, they raise. The
JAX package's one flash_attention call serves both the forward and, through
its custom VJP, the backward; here the caller's configuration picks
`FlashAttention` where a gradient will be asked for, never the autograd
state, so that a checkpointed block runs the same kernel in its first pass
and in its recomputation. K2 and the residual forward compute the same
function, the library's (fp32 probabilities in the row sum, rounded to the
input dtype only for the PV product): on the card one bf16 kernel serves
both (csrc/attention_fwd_sm90.cuh), the second call also writing lse.
"""

from __future__ import annotations

import torch

from reface_tpu_torch.ops import kernels
from reface_tpu_torch.ops.attention_smalld import (
    _GRAD_ROUTE,
    _LOG2E,
    check_operands,
    einsum_attention,
    self_attention_smalld,
)

__all__ = ["multi_head_attention", "attention_bhnd", "wide_attention",
           "FlashAttention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_bwd_dkv", "flash_bwd_dq", "ds_pitch", "flash_attention_fwd_plain",
           "flash_attention_bwd_plain", "flash_bwd_dkv_plain",
           "flash_bwd_dq_plain", "row_dot"]


# heads wider than one 128-column slice run the sliced kernels (the fp32
# forward inside csrc/attention_wide.cu, the backward in
# attention_flash_bwd_wide.cu)
_SLICE, _WIDE_MAX = 128, 512


def wide_attention(q, k, v, scale: float | None = None):
    """(BH, N, D) x (BH, M, D) attention forward (kernel K2). Returns q.dtype.

    CUDA: csrc/attention_wide.cu (bf16: the Hopper kernel of
    csrc/attention_fwd_sm90.cuh; fp32: the scalar kernel); D must be a
    multiple of 8 up to 128, or of 128 up to 512; no backward (a CUDA input
    that requires grad raises). CPU: the plain version, `einsum_attention`.
    """
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    if q.device.type == "cpu":
        return einsum_attention(q, k, v, scale)
    kernels.refuse_grad("wide_attention", _GRAD_ROUTE, q, k, v)
    check_operands(q, k, v, "wide_attention")
    if d % 8 or d > _WIDE_MAX or (d > _SLICE and d % _SLICE):
        raise ValueError(f"wide_attention: D={d} must be a multiple of 8 up to "
                         f"{_SLICE}, or of {_SLICE} up to {_WIDE_MAX}")
    bh, n, _ = q.shape
    out = torch.empty_like(q)
    lib = kernels.library("attention_wide")
    rc = lib.reface_wide_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, n,
        k.shape[1], d, scale * _LOG2E, kernels.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "wide_attention")
    kernels.count_launch(wide_attention, (bh, n, k.shape[1], d))
    return out


wide_attention.launches, wide_attention.shapes = 0, None


# ------------------------------------------------------------ flash attention
#
# The library flash_attention of jax.experimental.pallas.ops.tpu, which the
# JAX package differentiates in training: a forward that saves one row
# statistic per query (here the log-sum-exp; the library keeps l and m, and
# lse = m + log l), and a backward of two kernels, dK/dV (K4) and dQ (K5).

def row_dot(o, do):
    """di = sum(o * do, -1) in fp32, the backward's per-query row term
    (flash_attention.py:273 computes it outside any kernel too)."""
    return (o.float() * do.float()).sum(-1)


def flash_attention_fwd_plain(q, k, v, scale: float):
    """(BH, N, D) x (BH, M, D) -> (o in q.dtype, lse fp32 (BH, N)).

    The library forward with save_residuals=True: fp32 scores and softmax
    statistics, the fp32 probabilities summed into the row sum and rounded to
    v's dtype only for the PV product, which accumulates in fp32.
    """
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mx = s.amax(-1, keepdim=True)
    p = torch.exp(s - mx)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) * torch.reciprocal(l)
    return o.to(q.dtype), (mx + torch.log(l)).squeeze(-1)


def _probs_and_ds(q, k, v, lse, do, di, scale: float):
    """P = exp(scale q k^T - lse) and dS = P (dO v^T - di) scale, in fp32:
    the numerics of the library's mha_reference_bwd (flash_attention.py:
    1615-1675) with the scale folded in as its kernels fold it."""
    f = lambda t: t.float()
    p = torch.exp(torch.matmul(f(q), f(k).transpose(-1, -2)) * scale
                  - lse[..., None])
    dp = torch.matmul(f(do), f(v).transpose(-1, -2))
    return p, p * (dp - di[..., None]) * scale


# P and dS are rounded to the operands' dtype before the products that read
# them, as the library's kernels round them (a no-op in fp32).
def _dkv(q, k, v, do, p, ds):
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _dq(q, k, ds):
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, lse, do, di, scale: float):
    """K4's plain version: (dk, dv) from the saved lse and di."""
    p, ds = _probs_and_ds(q, k, v, lse, do, di, scale)
    return _dkv(q, k, v, do, p, ds)


def flash_bwd_dq_plain(q, k, v, lse, do, di, scale: float):
    """K5's plain version: dq from the saved lse and di."""
    return _dq(q, k, _probs_and_ds(q, k, v, lse, do, di, scale)[1])


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) of the flash forward's output o for the cotangent do."""
    p, ds = _probs_and_ds(q, k, v, lse, do, row_dot(o, do), scale)
    return (_dq(q, k, ds),) + _dkv(q, k, v, do, p, ds)





def _bwd_entry(d: int, name: str):
    """The C entry point of a backward kernel for head dim d."""
    if d > _SLICE:
        return getattr(kernels.library("attention_flash_bwd_wide"), name + "_wide")
    return getattr(kernels.library("attention_flash_bwd"), name)


def _check_flash(what, q, k, v, *rows):
    """Operands of the training kernels: q, k, v as K1/K2 take them, D a
    multiple of 8 up to 128 or a multiple of 128 up to 512 (the sliced
    kernels); `rows` are fp32 (BH, N) row statistics."""
    d = q.shape[-1]
    if d % 8 or d > _WIDE_MAX or (d > _SLICE and d % _SLICE):
        raise ValueError(f"{what}: D={d} must be a multiple of 8 up to {_SLICE}"
                         f", or a multiple of {_SLICE} up to {_WIDE_MAX}")
    check_operands(q, k, v, what)
    for r in rows:
        if r.dtype != torch.float32 or r.shape != q.shape[:2] \
                or r.device != q.device or not r.is_contiguous():
            raise ValueError(f"{what}: row statistics must be contiguous fp32 "
                             f"{tuple(q.shape[:2])} on q's device")


def flash_attention_fwd(q, k, v, scale: float):
    """The training forward (K2 with residuals): (o, lse).

    CUDA: reface_flash_attention_fwd of csrc/attention_wide.cu (bf16: the
    Hopper kernel of csrc/attention_fwd_sm90.cuh at every D; fp32: the
    scalar kernel, which cuts D > 128 into 128-column slices). CPU: the
    plain version, `flash_attention_fwd_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale)
    kernels.refuse_grad("flash_attention_fwd", "call FlashAttention.apply",
                        q, k, v)
    _check_flash("flash_attention_fwd", q, k, v)
    bh, n, d = q.shape
    m = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    lib = kernels.library("attention_wide")
    rc = lib.reface_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, n, m, d, scale * _LOG2E, kernels.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "flash_attention_fwd")
    kernels.count_launch(flash_attention_fwd, (bh, n, m, d))
    return o, lse


def _bwd_operands(what, q, k, v, lse, do, di):
    _check_flash(what, q, k, v, lse, di)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous() \
            or do.data_ptr() % 16:
        raise ValueError(f"{what}: do must be contiguous, 16-byte aligned and "
                         "of q's shape and dtype")


def flash_bwd_dkv(q, k, v, lse, do, di, scale: float):
    """K4: (dk, dv) from the saved lse and di = row_dot(o, do).

    CUDA: reface_flash_bwd_dkv of csrc/attention_flash_bwd.cu, or for
    D > 128 reface_flash_bwd_dkv_wide of csrc/attention_flash_bwd_wide.cu.
    CPU: the plain version.
    """
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, lse, do, di, scale)
    kernels.refuse_grad("flash_bwd_dkv", "it is FlashAttention's backward",
                        q, k, v, do)
    _bwd_operands("flash_bwd_dkv", q, k, v, lse, do, di)
    bh, n, d = q.shape
    m = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _bwd_entry(d, "reface_flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, n, m, d, scale,
        kernels.DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "flash_bwd_dkv")
    kernels.count_launch(flash_bwd_dkv, (bh, n, m, d))
    return dk, dv


def ds_pitch(m: int) -> int:
    """Row length of bf16 K5's dS workspace at D > 128: M rounded up to 8, a
    TMA row pitch of a multiple of 16 bytes (the keys in [M, pitch) hold 0)."""
    return -(-m // 8) * 8


def flash_bwd_dq(q, k, v, lse, do, di, scale: float, workspace=None):
    """K5: dq from the saved lse and di = row_dot(o, do).

    CUDA, D <= 128: reface_flash_bwd_dq of csrc/attention_flash_bwd.cu. bf16
    runs the Hopper kernel of csrc/attention_bwd_sm90.cuh: Q and dO resident
    for 128 queries a block, K and V streamed by TMA, S = Q K^T and
    dP = dO V^T by wgmma, dS built and rounded to bf16 in registers, then
    dQ += dS K with K read MN-major. fp32 runs the scalar kernel.
    CUDA, D > 128: reface_flash_bwd_dq_wide of
    csrc/attention_flash_bwd_wide.cu. bf16 runs two launches of
    csrc/attention_bwd_wide_sm90.cuh: dS, rounded to bf16 as the library
    rounds it for the dQ product, into a (BH, N, ds_pitch(M)) workspace,
    then dQ = dS K; the workspace is allocated here with torch.empty on q's
    device unless the caller passes one as `workspace` (contiguous bf16, that
    shape), and can then read dS from it. fp32 runs the sliced scalar kernel.
    Bound: the tensor cores, 6 BH N M D operations, each product run once
    (at D > 128 the workspace adds 4 BH N ds_pitch(M) bytes, which stay
    below it). Deterministic: one writer per element, no atomics.
    CPU: the plain version (`workspace` is not written).
    """
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, lse, do, di, scale)
    kernels.refuse_grad("flash_bwd_dq", "it is FlashAttention's backward",
                        q, k, v, do)
    _bwd_operands("flash_bwd_dq", q, k, v, lse, do, di)
    bh, n, d = q.shape
    m = k.shape[1]
    ws_shape = (bh, n, ds_pitch(m))
    if d > _SLICE and q.dtype == torch.bfloat16:
        if workspace is None:
            workspace = torch.empty(ws_shape, dtype=torch.bfloat16, device=q.device)
        elif workspace.shape != ws_shape or workspace.dtype != torch.bfloat16 \
                or workspace.device != q.device or not workspace.is_contiguous():
            raise ValueError(f"flash_bwd_dq: the workspace must be contiguous bf16 "
                             f"{ws_shape} on q's device")
        ws = (workspace.data_ptr(), ws_shape[2])
    elif workspace is not None:
        raise ValueError("flash_bwd_dq: only bf16 at D > 128 takes a workspace")
    else:
        ws = (None, 0) if d > _SLICE else ()
    dq = torch.empty_like(q)
    rc = _bwd_entry(d, "reface_flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
        di.data_ptr(), dq.data_ptr(), *ws, bh, n, m, d, scale,
        kernels.DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "flash_bwd_dq")
    kernels.count_launch(flash_bwd_dq, (bh, n, m, d))
    return dq


for _w in (flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq):
    _w.launches, _w.shapes = 0, None


def flash_attention_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv): K4 then K5 on a CUDA tensor, the plain version on the
    CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    di = row_dot(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, lse, do, di, scale)
    return flash_bwd_dq(q, k, v, lse, do, di, scale), dk, dv


class FlashAttention(torch.autograd.Function):
    """(BH, N, D) x (BH, M, D) attention with the library's custom VJP
    (flash_attention.py:204-318): the forward saves o and lse, the backward
    recomputes the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def attention_bhnd(q, k, v, scale: float | None = None, impl: str = "auto"):
    """Attention over (B, H, N, D) tensors. Returns (B, H, N, D)."""
    if impl not in ("auto", "fast", "flash", "einsum"):
        raise ValueError(f"unknown attention impl {impl!r}")
    b, h, n, d = q.shape
    m = k.shape[2]
    scale = d**-0.5 if scale is None else scale
    on_card = q.is_cuda
    if impl in ("auto", "fast") and on_card and n == m and n >= 512 and d <= 256:
        kern = lambda q3, k3, v3: self_attention_smalld(
            q3, k3, v3, scale=scale, fast=impl == "fast")
    elif impl == "flash" and on_card and n >= 1024 and m >= 128:
        kern = lambda q3, k3, v3: FlashAttention.apply(q3, k3, v3, scale)
    elif impl != "einsum" and on_card and n >= 1024 and m >= 128:
        kern = lambda q3, k3, v3: wide_attention(q3, k3, v3, scale=scale)
    else:
        return einsum_attention(q, k, v, scale)
    flat = lambda t: t.reshape(b * h, t.shape[2], d).contiguous()
    return kern(flat(q), flat(k), flat(v)).reshape(b, h, n, d)


def multi_head_attention(q, k, v, num_heads: int, impl: str = "auto"):
    """(B, N, H*D) x (B, M, H*D) -> (B, N, H*D) with fp32-softmax."""
    b, n, inner = q.shape
    m = k.shape[1]
    d = inner // num_heads
    qh = q.reshape(b, n, num_heads, d).transpose(1, 2)
    kh = k.reshape(b, m, num_heads, d).transpose(1, 2)
    vh = v.reshape(b, m, num_heads, d).transpose(1, 2)
    out = attention_bhnd(qh, kh, vh, impl=impl)
    return out.transpose(1, 2).reshape(b, n, inner)
