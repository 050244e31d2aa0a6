"""Operations and bytes of the work a cell does, from the configuration's
shapes alone.

Model FLOPs are counted by torch.utils.flop_counter.FlopCounterMode over
the reference modules (gpubench/reference/nets.py) built on the meta
device: every product and convolution of the computation as the program
runs it, elementwise work not counted. Attention calls are counted by hand:
a forward is 4 N M D multiply-adds x2 (Q K^T and P V), a backward 2.5 times
that (S recomputed, then dV, dP, dQ, dK), and its bytes are each input read
once and each output written once.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def count(fn) -> int:
    """FLOPs of the products and convolutions fn() runs."""
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip can take: the larger of the operations at the
    bf16 tensor peak and the bytes at the memory peak."""
    return max(flops / PEAKS["bf16_flops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])


def attention_call(bh: int, n: int, m: int, d: int, kind: str) -> tuple[float, float]:
    """(FLOPs, bytes) of one bf16 attention call over bh heads of n queries
    and m keys of width d. kind: "fwd" (reads Q, K, V, writes O), "fwd_lse"
    (also writes the fp32 row log-sum-exp a backward needs), "bwd" (reads
    Q, K, V, O, dO and the log-sum-exp, writes dQ, dK, dV)."""
    fwd = 4.0 * bh * n * m * d
    q, kv = bh * n * d * 2, bh * m * d * 2
    if kind == "fwd":
        return fwd, 2 * q + 2 * kv
    if kind == "fwd_lse":
        return fwd, 2 * q + 2 * kv + 4 * bh * n
    if kind == "bwd":
        return 2.5 * fwd, (3 * q + 2 * kv + 4 * bh * n) + (q + 2 * kv)
    raise ValueError(kind)


def unet_self_attention_layers(unet: dict, latent: int):
    """(tokens, head width) of each UNet self-attention, in the order the
    forward runs them."""
    mults, nres = unet["channel_mult"], unet["num_res_blocks"]
    depth, heads, mc = unet["transformer_depth"], unet["num_heads"], unet["model_channels"]
    layers, ds = [], 1
    for level, mult in enumerate(mults):
        if ds in unet["attention_resolutions"]:
            layers += [((latent // ds) ** 2, mult * mc // heads)] * (nres * depth)
        if level != len(mults) - 1:
            ds *= 2
    layers += [((latent // ds) ** 2, mults[-1] * mc // heads)] * depth  # the middle block
    for level, mult in reversed(list(enumerate(mults))):
        if ds in unet["attention_resolutions"]:
            layers += [((latent // ds) ** 2, mult * mc // heads)] * ((nres + 1) * depth)
        if level:
            ds //= 2
    return layers
