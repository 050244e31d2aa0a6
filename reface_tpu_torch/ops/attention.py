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
both (csrc/attention_fwd_sm90.cuh), the second call also writing lse. A
head wider than 128 that is not a multiple of 128 (a 1024 px UNet's d=160)
runs K2 and the flash kernels zero-padded to the next multiple of 128, as
the JAX package's _flash_attention pads it (`pad_head_dim`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
           "flash_bwd_dkv", "flash_bwd_dq", "ds_pitch", "padded_head_dim", "pad_head_dim",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain", "flash_bwd_dkv_plain",
           "flash_bwd_dq_plain", "flash_bwd_ds_plain", "row_dot"]


# heads wider than one 128-column slice run the wide kernels (the split bf16
# forward or the sliced fp32 one in csrc/attention_wide.cu, the backward in
# attention_flash_bwd_wide.cu), which take multiples of 128
_SLICE, _WIDE_MAX = 128, 512


def padded_head_dim(d: int) -> int:
    """The head dim the kernels run a head of d at: d up to 128, above it d
    rounded up to a multiple of 128."""
    return d if d <= _SLICE else -(-d // _SLICE) * _SLICE


def pad_head_dim(*ts):
    """The (BH, L, D) tensors with their last dim zero-padded to
    padded_head_dim(D), or unchanged where that is D: the padding of the JAX
    package's _flash_attention (reface_tpu/ops/attention.py:50-55). Zero
    columns change no score, and the outputs' extra columns are sliced off
    (`_unpad`); the caller keeps the scale of the real D."""
    d = ts[0].shape[-1]
    pad = padded_head_dim(d) - d
    return ts if pad == 0 else tuple(F.pad(t, (0, pad)) for t in ts)


def _unpad(t, d: int):
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _check_head_dim(what: str, d: int) -> None:
    if d % 8 or d > _WIDE_MAX:
        raise ValueError(f"{what}: D={d} must be a multiple of 8 up to {_WIDE_MAX}")


def wide_attention(q, k, v, scale: float | None = None):
    """(BH, N, D) x (BH, M, D) attention forward (kernel K2). Returns q.dtype.

    CUDA: csrc/attention_wide.cu (bf16: the Hopper kernel of
    csrc/attention_fwd_sm90.cuh; fp32: the scalar kernel) at
    padded_head_dim(D); D must be a multiple of 8 up to 512; no backward (a
    CUDA input that requires grad raises). CPU: the plain version,
    `einsum_attention`.
    """
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    if q.device.type == "cpu":
        return einsum_attention(q, k, v, scale)
    kernels.refuse_grad("wide_attention", _GRAD_ROUTE, q, k, v)
    check_operands(q, k, v, "wide_attention")
    _check_head_dim("wide_attention", d)
    bh, n, _ = q.shape
    m = k.shape[1]
    q, k, v = pad_head_dim(q, k, v)
    out = torch.empty_like(q)
    lib = kernels.library("attention_wide")
    rc = lib.reface_wide_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, n, m,
        q.shape[-1], scale * _LOG2E, kernels.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "wide_attention")
    kernels.count_launch(wide_attention, (bh, n, m, d))
    return _unpad(out, d)


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


def flash_bwd_ds_plain(q, k, v, lse, do, di, scale: float):
    """The plain version of bf16 K4's and K5's workspaces at D > 128: (dS,
    P) rounded to bf16 as the dS/P kernel stores them, (BH, N, ds_pitch(M))
    with 0 at the keys in [M, ds_pitch(M)). dS is the value both backward
    products round (`_dq`, `_dkv`), P the one dV's rounds."""
    p, ds = _probs_and_ds(q, k, v, lse, do, di, scale)
    pad = ds_pitch(k.shape[1]) - k.shape[1]
    return tuple(F.pad(t, (0, pad)).to(torch.bfloat16) for t in (ds, p))


def _bwd_entry(d: int, name: str):
    """The C entry point of a backward kernel for head dim d."""
    if d > _SLICE:
        return getattr(kernels.library("attention_flash_bwd_wide"), name + "_wide")
    return getattr(kernels.library("attention_flash_bwd"), name)


def _check_flash(what, q, k, v, *rows):
    """Operands of the training kernels: q, k, v as K1/K2 take them, D a
    multiple of 8 up to 512 (run at padded_head_dim(D)); `rows` are fp32
    (BH, N) row statistics."""
    _check_head_dim(what, q.shape[-1])
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
    scalar kernel, which cuts D > 128 into 128-column slices), at
    padded_head_dim(D). CPU: the plain version, `flash_attention_fwd_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale)
    kernels.refuse_grad("flash_attention_fwd", "call FlashAttention.apply",
                        q, k, v)
    _check_flash("flash_attention_fwd", q, k, v)
    bh, n, d = q.shape
    m = k.shape[1]
    q, k, v = pad_head_dim(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    lib = kernels.library("attention_wide")
    rc = lib.reface_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, n, m, q.shape[-1], scale * _LOG2E, kernels.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "flash_attention_fwd")
    kernels.count_launch(flash_attention_fwd, (bh, n, m, d))
    return _unpad(o, d), lse


def _bwd_operands(what, q, k, v, lse, do, di):
    _check_flash(what, q, k, v, lse, di)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous() \
            or do.data_ptr() % 16:
        raise ValueError(f"{what}: do must be contiguous, 16-byte aligned and "
                         "of q's shape and dtype")


def ds_pitch(m: int) -> int:
    """Row length of the bf16 dS and P workspaces at D > 128: M rounded up
    to 8, a TMA row pitch of a multiple of 16 bytes (the keys in [M, pitch)
    hold 0)."""
    return -(-m // 8) * 8


def _workspace(what, w, q, m: int):
    """w, checked, or a new (BH, N, ds_pitch(M)) bf16 workspace on q's
    device when w is None."""
    shape = (q.shape[0], q.shape[1], ds_pitch(m))
    if w is None:
        return torch.empty(shape, dtype=torch.bfloat16, device=q.device)
    if w.shape != shape or w.dtype != torch.bfloat16 or w.device != q.device \
            or not w.is_contiguous():
        raise ValueError(f"{what}: a workspace must be contiguous bf16 {shape} on q's device")
    return w


def _wide_bf16(q) -> bool:
    return q.dtype == torch.bfloat16 and q.shape[-1] > _SLICE


def _ds_launch(q, k, v, lse, do, di, scale: float, ds, p) -> None:
    """bf16 at D > 128 (D a multiple of 128): dS, and P unless p is None,
    rounded to bf16 into the workspaces; one launch of flash_bwd_ds_sm90
    (csrc/attention_bwd_wide_sm90.cuh), counted by the wrapper that calls
    it."""
    bh, n, d = q.shape
    m = k.shape[1]
    rc = kernels.library("attention_flash_bwd_wide").reface_flash_bwd_ds_wide(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(), di.data_ptr(),
        ds.data_ptr(), None if p is None else p.data_ptr(), ds_pitch(m), bh, n, m, d, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "flash_bwd_ds")


def flash_bwd_dkv(q, k, v, lse, do, di, scale: float, workspaces=None):
    """K4: (dk, dv) from the saved lse and di = row_dot(o, do).

    CUDA, D <= 128: reface_flash_bwd_dkv of csrc/attention_flash_bwd.cu
    (bf16: the Hopper kernel of csrc/attention_bwd_sm90.cuh; fp32: the
    scalar kernel). CUDA, D > 128, at padded_head_dim(D):
    reface_flash_bwd_dkv_wide of csrc/attention_flash_bwd_wide.cu. bf16 runs
    dV = P^T dO and dK = dS^T Q as one launch of flash_bwd_dkv_gemm_sm90
    (csrc/attention_bwd_wide_sm90.cuh), reading P and dS, rounded to bf16,
    from (BH, N, ds_pitch(M)) workspaces: `workspaces` = (dS, P) as
    flash_bwd_dq wrote them, or None, and then this call runs the dS/P
    launch itself first. fp32 runs the sliced scalar kernel. Bound: the
    tensor cores, 4 BH N M D operations for the GEMMs (8 with the dS/P
    launch). CPU: the plain version (`workspaces` are not read).
    """
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, lse, do, di, scale)
    kernels.refuse_grad("flash_bwd_dkv", "it is FlashAttention's backward",
                        q, k, v, do)
    _bwd_operands("flash_bwd_dkv", q, k, v, lse, do, di)
    bh, n, d0 = q.shape
    m = k.shape[1]
    q, k, v, do = pad_head_dim(q, k, v, do)
    d = q.shape[-1]
    if _wide_bf16(q):
        if workspaces is None:
            workspaces = tuple(_workspace("flash_bwd_dkv", None, q, m) for _ in range(2))
            _ds_launch(q, k, v, lse, do, di, scale, *workspaces)
        ds, p = (_workspace("flash_bwd_dkv", w, q, m) for w in workspaces)
        ws = (ds.data_ptr(), p.data_ptr(), ds_pitch(m))
    elif workspaces is not None:
        raise ValueError("flash_bwd_dkv: only bf16 at D > 128 takes workspaces")
    else:
        ws = (None, None, 0) if d > _SLICE else ()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _bwd_entry(d, "reface_flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(), *ws, bh, n, m, d, scale,
        kernels.DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "flash_bwd_dkv")
    kernels.count_launch(flash_bwd_dkv, (bh, n, m, d0))
    return _unpad(dk, d0), _unpad(dv, d0)


def flash_bwd_dq(q, k, v, lse, do, di, scale: float, workspace=None, p_workspace=None):
    """K5: dq from the saved lse and di = row_dot(o, do).

    CUDA, D <= 128: reface_flash_bwd_dq of csrc/attention_flash_bwd.cu. bf16
    runs the Hopper kernel of csrc/attention_bwd_sm90.cuh: Q and dO resident
    for 128 queries a block, K and V streamed by TMA, S = Q K^T and
    dP = dO V^T by wgmma, dS built and rounded to bf16 in registers, then
    dQ += dS K with K read MN-major. fp32 runs the scalar kernel.
    CUDA, D > 128, at padded_head_dim(D): csrc/attention_flash_bwd_wide.cu.
    bf16 runs two launches of csrc/attention_bwd_wide_sm90.cuh: dS, rounded
    to bf16 as the library rounds it for the dQ product, into a (BH, N,
    ds_pitch(M)) workspace (and P, rounded as dV's product rounds it, into
    `p_workspace` when one is passed), then dQ = dS K. The dS workspace is
    allocated here with torch.empty on q's device unless the caller passes
    one as `workspace` (contiguous bf16, that shape), and can then read dS
    from it: flash_attention_bwd passes both, and flash_bwd_dkv reads them.
    fp32 runs the sliced scalar kernel.
    Bound: the tensor cores, 6 BH N M D operations, each product run once
    (at D > 128 the dS workspace adds 4 BH N ds_pitch(M) bytes, written and
    read, and P 2 BH N ds_pitch(M), written; both stay below it).
    Deterministic: one writer per element, no atomics.
    CPU: the plain version (the workspaces are not written).
    """
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, lse, do, di, scale)
    kernels.refuse_grad("flash_bwd_dq", "it is FlashAttention's backward",
                        q, k, v, do)
    _bwd_operands("flash_bwd_dq", q, k, v, lse, do, di)
    bh, n, d0 = q.shape
    m = k.shape[1]
    q, k, v, do = pad_head_dim(q, k, v, do)
    d = q.shape[-1]
    if _wide_bf16(q):
        ds = _workspace("flash_bwd_dq", workspace, q, m)
        p = None if p_workspace is None else _workspace("flash_bwd_dq", p_workspace, q, m)
        _ds_launch(q, k, v, lse, do, di, scale, ds, p)
        ws = (ds.data_ptr(), ds_pitch(m))
    elif workspace is not None or p_workspace is not None:
        raise ValueError("flash_bwd_dq: only bf16 at D > 128 takes a workspace")
    else:
        ws = (None, 0) if d > _SLICE else ()
    dq = torch.empty_like(q)
    rc = _bwd_entry(d, "reface_flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
        di.data_ptr(), dq.data_ptr(), *ws, bh, n, m, d, scale,
        kernels.DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "flash_bwd_dq")
    kernels.count_launch(flash_bwd_dq, (bh, n, m, d0))
    return _unpad(dq, d0)


for _w in (flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq):
    _w.launches, _w.shapes = 0, None


def flash_attention_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv): K5 and K4 on a CUDA tensor, the plain version on the
    CPU. In bf16 at D > 128 K5's call runs the one dS/P launch that both
    read (its row owns that launch), and K4's runs its GEMM alone."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    di = row_dot(o, do)
    kw_dq, kw_dkv = {}, {}
    if _wide_bf16(q):
        ds, p = (_workspace("flash_attention_bwd", None, q, k.shape[1]) for _ in range(2))
        kw_dq, kw_dkv = {"workspace": ds, "p_workspace": p}, {"workspaces": (ds, p)}
    dq = flash_bwd_dq(q, k, v, lse, do, di, scale, **kw_dq)
    return (dq,) + flash_bwd_dkv(q, k, v, lse, do, di, scale, **kw_dkv)


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
