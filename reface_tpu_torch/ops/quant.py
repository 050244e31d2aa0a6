"""Int8 serving-mode products (port of reface_tpu/ops/quant.py), NCHW.

Symmetric quantisation: per-output-channel weight scales, dynamic
activation scales (per row for a dense product, per sample for a conv),
int8 x int8 -> int32 product, dequantised into the requested dtype. The
arithmetic is the JAX package's as written: amax in fp32, scale =
max(amax, 1e-8) / 127, q = clip(round(x / scale), -127, 127) with
round-half-to-even, out = acc * (x_scale * w_scale) in fp32.

The JAX package computes the int8 product with XLA (dot_general /
conv_general_dilated with preferred_element_type=int32), outside any
Pallas kernel. So does the port: `int_mm` runs torch._int_mm (cuBLASLt's
int8 GEMM) on a CUDA tensor, zero-padding the rows, K or N where its shape
rules ask for it (exact in integers), and on a CPU tensor its plain
version, `int_mm_plain`. The conv is an implicit im2col: the kh*kw shifted
views of the padded channels-last int8 input, concatenated in (kh, kw, C)
order to match the weight's (kh, kw, I, O) layout, go through one product.

Layers quantise their weight once and keep it until the weight changes
(`cached_weight`), as XLA hoists the quantisation out of the sampler's
scan in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reface_tpu_torch.ops import kernels

__all__ = ["QUANT_MODES", "quant_int8", "quant_rows", "int_mm", "int_mm_plain",
           "int8_dense", "int8_dense_q", "int8_conv", "int8_conv_q", "conv_weight_q",
           "cached_weight"]

# "int8": every QDense and QConv site; "int8conv": the QConv sites only
QUANT_MODES = ("none", "int8", "int8conv")
# the largest K whose int8 x int8 sums cannot overflow int32: 127^2 * K < 2^31
_K_MAX = (2**31 - 1) // 127**2


def _scale(t32: torch.Tensor, dim) -> torch.Tensor:
    """max(amax over `dim`, 1e-8) / 127 in fp32. The divisor is a tensor on
    t32's device: CUDA divides by a Python number as a product with its
    reciprocal, which can be one bit off the division the CPU and the JAX
    package compute, and move a value across a rounding boundary."""
    amax = torch.clamp(t32.abs().amax(dim=dim, keepdim=True), min=1e-8)
    return amax / amax.new_full((), 127.0)


def quant_int8(w: torch.Tensor, dim=0):
    """Symmetric int8 quantisation with scales over the contraction `dim`(s)
    of the weight, i.e. one scale per output channel, kept as size 1.
    Returns (q int8, scale fp32)."""
    w32 = w.float()
    scale = _scale(w32, dim)
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return q.to(torch.int8), scale


def quant_rows(x: torch.Tensor, dim):
    """Dynamic activation quantisation with one scale per slice over `dim`
    (the last dim: per row; the C, H, W dims: per sample)."""
    x32 = x.float()
    scale = _scale(x32, dim)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int_mm_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M,K) int8 x (N,K) int8 -> (M,N) int32 = a @ w^T, exact: every
    partial sum is an integer below 127^2 * K < 2^31 < 2^53, so float64 adds
    it exactly in any order, on any device."""
    return torch.matmul(a.double(), w.double().t()).to(torch.int32)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, extra]
    return F.pad(t, pad)


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M,K) int8 x (N,K) int8 -> (M,N) int32 = a @ w^T.

    CUDA: torch._int_mm on a row-major a and w^T (both K-major), whose
    shape rules (M > 16; K and N multiples of 8) are met by zero rows and
    columns, sliced off after: exact either way. CPU: int_mm_plain. No float
    product on either device."""
    (m, k), n = a.shape, w.shape[0]
    if k > _K_MAX:
        raise ValueError(f"int_mm: K={k} could overflow the int32 accumulator")
    if a.device.type == "cpu":
        return int_mm_plain(a, w)
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    ap = _pad_to(_pad_to(a, 0, mp), 1, kp).contiguous()
    wp = _pad_to(_pad_to(w, 0, np_), 1, kp).contiguous()
    out = torch._int_mm(ap, wp.t())
    kernels.count_launch(int_mm, (m, k, n))
    return out if (mp, np_) == (m, n) else out[:m, :n]


int_mm.launches, int_mm.shapes = 0, None


def int8_dense(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x @ w^T with both sides int8-quantised on the fly: x (..., K), w a
    torch Linear's (N, K) weight. Per-row activation scales (an outlier
    token degrades only its own row), per-output-channel weight scales.
    Returns (..., N) in out_dtype (default x's)."""
    return int8_dense_q(x, *quant_int8(w, dim=1), out_dtype=out_dtype)


def int8_dense_q(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """int8_dense with the weight quantised already: wq (N, K) int8,
    w_scale (N, 1) fp32."""
    out_dtype = out_dtype or x.dtype
    xq, x_scale = quant_rows(x, -1)  # (..., K) int8, (..., 1)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    acc = acc.reshape(*x.shape[:-1], wq.shape[0])
    return (acc.float() * (x_scale * w_scale.reshape(-1))).to(out_dtype)


def conv_weight_q(w: torch.Tensor):
    """quant_int8 of a torch Conv2d's (O, C, kh, kw) weight, one scale per O,
    with the int8 weight laid out as int8_conv_q's (O, kh*kw*C) matrix."""
    wq, w_scale = quant_int8(w, dim=(1, 2, 3))
    return wq.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous(), w_scale


def int8_conv(x: torch.Tensor, w: torch.Tensor, padding: int,
              out_dtype=None) -> torch.Tensor:
    """Stride-1 NCHW conv with both sides int8-quantised on the fly: x
    (B,C,H,W), w a torch Conv2d's (O, C, k, k) weight. Per-sample
    activation scales (one output pixel mixes k*k input pixels, so the
    scale is constant over the window), per-output-channel weight scales.
    Returns (B, O, H', W') in out_dtype (default x's)."""
    return int8_conv_q(x, *conv_weight_q(w), w.shape[-1], padding, out_dtype)


def int8_conv_q(x: torch.Tensor, wmat: torch.Tensor, w_scale: torch.Tensor,
                k: int, padding: int, out_dtype=None) -> torch.Tensor:
    """int8_conv with the weight quantised already (conv_weight_q): wmat
    (O, k*k*C) int8 in (kh, kw, C) order, w_scale (O, 1, 1, 1) fp32. The
    output is a channels-last view."""
    out_dtype = out_dtype or x.dtype
    o = wmat.shape[0]
    xq, x_scale = quant_rows(x, (1, 2, 3))  # per sample: (B,1,1,1)
    xq = F.pad(xq.permute(0, 2, 3, 1), (0, 0, padding, padding, padding, padding))
    b, hp, wp, c = xq.shape
    ho, wo = hp - k + 1, wp - k + 1
    cols = [xq[:, i: i + ho, j: j + wo, :] for i in range(k) for j in range(k)]
    cols = cols[0] if k == 1 else torch.cat(cols, dim=-1)
    acc = int_mm(cols.reshape(b * ho * wo, k * k * c), wmat)
    scale = x_scale.reshape(b, 1, 1, 1) * w_scale.reshape(1, 1, 1, o)
    out = (acc.reshape(b, ho, wo, o).float() * scale).to(out_dtype)
    return out.permute(0, 3, 1, 2)


def cached_weight(layer: torch.nn.Module, quantise):
    """quantise(layer.weight), computed once and kept on the layer until its
    weight is replaced or written in place (load_state_dict copies in place,
    which moves the weight's version)."""
    w = layer.weight
    key = (w.data_ptr(), w.device, w.dtype, 0 if w.is_inference() else w._version)
    cached = layer.__dict__.get("_int8_weight")
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, quantise(w.detach()))
        layer.__dict__["_int8_weight"] = cached
    return cached[1]
