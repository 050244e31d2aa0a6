#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (reface_tpu_torch) on one NVIDIA GPU.

Run from the root of the repo on a machine with a CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of reface_tpu, builds the port's kernels from
reface_tpu_torch/csrc/ (one nvcc per source, all started together), builds
the SwapConfig() towers (the SD-v1 REFace widths) on the card from seeded
random weights with the reference's zero-initialised layers re-randomised,
and surveys the kernels' call shapes as their wrappers record them in one
UNet forward, one VAE encode and decode, and one fused UNet forward. Then:

  1. device: the card's name and power limit (nvidia-smi), the build time of
     each source, and the SASS of the Hopper kernels (cuobjdump: every bf16
     instance of the attention forward, K1's included, of K4 and K5 at
     D <= 128 and of K5's two d = 512 kernels must hold wgmma and TMA
     instructions, HGMMA and UTMALDG, and no bf16 mma.sync instance of the
     old kernels they replace may be left to reach, but K1's at
     128 < D <= 256, which must have K1's rules, and K4's at d = 512);
  2. kernels: K1 (UNet self-attention), K2 (VAE mid-block attention) and K3
     (GroupNorm+SiLU) against their plain PyTorch versions at every shape the
     survey found, K1 also at ragged and tiny shapes and at d = 160 (the
     mma.sync instance, timed beside sdpa) and K2 at ragged shapes and
     D = 40, 80, 256, in bf16 and fp32 (TF32 off); bf16 K1 also against
     the TPU kernel's own function (smalld_attention_plain, both modes, one
     bf16 ulp), bf16 K2 against the library's function
     (flash_attention_fwd_plain, one bf16 ulp) and bit-equal to the residual
     forward; each timed with CUDA events beside its bound (bytes, tensor
     operations or exp2s), its plain version and one PyTorch library call;
  3. the main path: 512 px, DDIM-50, CFG 3, CFG prefix dedup, 2 requests of
     batch 2 through FaceSwapper.swap; checks the output and the kernels'
     launch counts;
  4. bf16 against fp32: the UNet (unfused, and UNetConfig(fused_groupnorm=
     True) through K3), the VAE and the conditioner, each at full width
     against an fp32 copy with the same weights;
  5. a small input against a reference: the 256 px tiny config in fp32 on the
     card (K1, K2 and K3 all launched) against the port on the CPU, where
     every kernel wrapper computes its plain version;
  6. the training kernels against their plain versions at the shapes of the
     UNet's self-attention in training (batch 4: (BH,N,D) = (32,4096,40) and
     (32,1024,80), and ragged ones at d = 40 and 80) and of the VAE decoder's
     mid-block ((1,4096,512), (4,4096,512), a ragged one, and a ragged
     d = 256 off the main path), bf16 and fp32: the forward with
     residuals (K2's o and lse), K4 (dk, dv) and K5 (dq; at d > 128 in bf16
     also its dS workspace, against the plain dS rounded to bf16, zeros at
     keys past M included), each timed beside its bound, its plain version
     and scaled_dot_product_attention (for K4 and K5 its backward alone,
     which computes dq, dk and dv together from a kept forward, and beside
     it the forward and backward);
  7. the eps-MSE training path: make_train_step(SwapConfig(), ...) at batch 4
     and 512 px, 2 steps on seeded random weights; checks the loss, that
     every trainable parameter moved and every frozen one did not, the
     kernels' launches per step against the plan, one step's loss and UNet
     gradient against the same step with attn_impl="einsum", and a tiny fp32
     step on the card against the CPU port;
  8. the full-loss training path: make_train_step(SwapConfig(), ...,
     recon=ReconLossConfig()) (eps-MSE plus the 4-step DDIM reconstruction
     with ID and LPIPS losses) at 512 px, batch 4 if it fits the card, 2
     steps; checks the metrics, the moved and the frozen tensors, the
     launches per step and shape against the plan worked out from the config
     (the VAE decoder under autograd launches FlashAttention at d=512 and
     never K2), the split_grad=2 step against the monolith, and a tiny fp32
     full-loss step on the card against the CPU port.

It prints one JSON line of kernel numbers and, last, {"ok": true, "device":
...}. Any failure exits non-zero before that line; without a CUDA device it
exits non-zero at once.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import re
import shutil
import subprocess
import time

import torch
import torch.nn.functional as F

from reface_tpu_torch.nn.conditioner import REFaceConditioner
from reface_tpu_torch.nn.unet import UNetModel
from reface_tpu_torch.nn.vae import AutoencoderKL
from reface_tpu_torch.nn.layers import CrossAttention
from reface_tpu_torch.ops import attention as PA
from reface_tpu_torch.ops import kernels
from reface_tpu_torch.ops.attention import wide_attention
from reface_tpu_torch.ops.attention_smalld import (
    einsum_attention,
    self_attention_smalld,
    smalld_attention_plain,
)
from reface_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain
from reface_tpu_torch.pipelines.swap import (
    FaceSwapper,
    SwapConfig,
    clip_normalize,
    init_params,
    tiny_swap_config,
    un_norm,
)
from reface_tpu_torch.pipelines.train import (
    ReconLossConfig,
    TrainConfig,
    make_draws,
    make_train_step,
    named_params,
    trainable_labels,
)

# NVIDIA H100 SXM data sheet (dense, 700 W): the bounds below use these.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}  # tensor-core bf16; fp32 outside the tensor cores
# exp2 a second on the special-function units: 16 a clock on each of the 132
# SMs (FlashAttention-3, Shah et al. 2024, section 3). Attention takes one
# per score, BH*N*M, which binds before the tensor cores at small head dims.
EXP_PER_S = 3.9e12
BATCH = 2
REQUESTS = 2
UNET_PARAMS = 859_535_364  # UNetConfig(): SD-v1 UNet with the 9-channel conv_in
# Launches the plan of the slice expects, against which the survey is held.
# K1: the SpatialTransformers at 64x64 and 32x32 latents (2 + 3 at each);
# K2: the VAE encoder's and decoder's mid-block; K3: two norms in each of the
# 22 ResBlocks and the output norm.
PLANNED = {"K1 per UNet forward": 10, "K2 per swap": 2, "K3 per fused UNet forward": 45}

# Tolerances of kernel vs plain version. fp32: both sides in full fp32 (TF32
# off), only summation order differs. bf16: the outputs are bf16 (one ulp is
# 2^-8 relative), and the attention kernels round the probabilities to bf16
# relative to a shift where einsum_attention rounds normalised ones (K1
# shifts by the max of the first 256 keys, or not at all when fast, and sums
# the rounded values, the JAX smalld kernel's rule; K2 shifts by a running
# max and sums the fp32 ones, the library flash kernel's rule); max abs
# errors seen 1.95e-3 (K1) and 9.77e-4 (K2), while the plain version with its
# last key tile dropped is further off than either limit (phase 2 prints by
# how much). bf16 is also held to a relative L2 error. Each is held besides
# to the plain version of its own function, which rounds at the same places,
# within one bf16 ulp of the largest |o| (K1_ULPS, K2_ULPS):
# smalld_attention_plain for K1, flash_attention_fwd_plain's o for K2.
TOL = {
    "K1": {"fp32": 2e-5, "bf16": 5e-3},
    "K2": {"fp32": 2e-5, "bf16": 5e-3},
    # GroupNorm outputs reach |y| ~ 6: one bf16 ulp there is 2^-5
    "K3": {"fp32": 1e-4, "bf16": 2**-5},
}
REL_TOL_BF16 = 1e-2
K1_ULPS = K2_ULPS = 1
# bf16 K1 at 128 < D <= 256 (csrc/attention_smalld.cu's mma.sync instance):
# off the 512 px main path, reached by a 1024 px input's 1024 tokens at d=160
K1_WIDE_SHAPES = [(16, 1024, 1024, 160), (3, 600, 600, 160)]
# Relative L2 distance of each bf16 tower from an fp32 copy with the same
# weights (phase 4); random weights, full width. About twice what was seen:
# UNet 1.42e-2, fused 1.36e-2, VAE encode 1.57e-2, decode 1.17e-2,
# conditioner 7.2e-4 (its output is mostly the fp32 ID projection).
TOWER_TOL = {"UNet": 3e-2, "UNet fused": 3e-2, "VAE encode": 3e-2,
             "VAE decode": 3e-2, "conditioner": 2e-3}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
KERNELS = (self_attention_smalld, wide_attention, group_norm_silu,
           PA.flash_attention_fwd, PA.flash_bwd_dkv, PA.flash_bwd_dq)

# Training (phases 6-7). The UNet's self-attention at batch 4: 8 heads of
# d=40 over 4096 tokens and of d=80 over 1024, five of each per step.
TRAIN_BATCH = 4
TRAIN_STEPS = 2
TRAIN_SHAPES = ((32, 4096, 4096, 40), (32, 1024, 1024, 80))
# The VAE decoder's mid-block attention, which the full loss differentiates:
# one head of d=512 over 4096 tokens. Checked at batch 1, at the training
# batch and at a ragged shape (N, M not multiples of 64); timed at the
# training batch.
WIDE_SHAPES = ((1, 4096, 4096, 512), (TRAIN_BATCH, 4096, 4096, 512), (2, 1000, 1100, 512),
               (2, 1000, 1100, 256))
# Ragged shapes (N, M not multiples of any tile) at the UNet's head widths,
# checked beside TRAIN_SHAPES in phase 6; (2, 1000, 1100, 256) above is a
# width off the main path.
RAGGED_SHAPES = ((32, 1000, 1100, 40), (4, 1000, 1100, 80))


def fwd_key_tile(d: int) -> int:
    """Keys per tile of the bf16 forward (csrc/attention_fwd_sm90.cuh:
    kBN = 128 at D <= 128, 32 above): the dropped-tile checks drop these."""
    return 128 if d <= 128 else 32

# Launches per training step, in KERNELS order: under remat the forward of
# each of the 10 flash self-attentions runs twice; K4 and K5 once each in
# the backward; K2 once per VAE encode (target and masked target); no K1, no
# K3 (fused_groupnorm is off in SwapConfig()).
TRAIN_PLAN = (0, 2, 0, 20, 10, 10)
# Phase 6 tolerances, kernel vs plain version on the same inputs. fp32: full
# fp32 on both sides, only summation order differs (seen <= 6e-7). bf16: the
# outputs are bf16 and P and dS are rounded to bf16 at the same places on
# both sides; the forward's o as K2 (seen 9.8e-4 to 2e-3), the gradients
# (|g| < 2) within one bf16 ulp at 2, 2^-7 (seen <= 2e-3), and every bf16
# output also within REL_TOL_BF16 relative L2 (seen <= 2.4e-3). lse is fp32
# on both sides (seen 1.9e-6 at |lse| ~ 9.5).
TOL.update({"K2r": {"fp32": 2e-5, "bf16": 5e-3},
            "K4": {"fp32": 2e-5, "bf16": 2**-7},
            "K5": {"fp32": 2e-5, "bf16": 2**-7}})
LSE_TOL = 1e-5
# Phase 7: one bf16 step with FlashAttention against the same step with the
# plain attention product on the card (same weights, batch and draws). Both
# round to bf16, at different places inside the attention (P relative to a
# running max against normalised weights); the UNet's bf16 backward carries
# that through every layer. Seen on the H100: loss 2.3e-5 relative, UNet
# gradient 1.65e-3 relative L2; the limits are about 10x and 6x that.
TRAIN_TOL = {"loss": 2e-4, "grad": 1e-2}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts():
    return tuple(k.launches for k in KERNELS)


def time_ms(fn, budget_ms: float = 250.0) -> float:
    """Mean device time of fn() from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    iters = int(min(50, max(3, budget_ms / max(a.elapsed_time(b), 1e-3))))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, calls: int = 5) -> float:
    """Mean device time of fn() from torch.profiler: the kernels it launches,
    summed, per call. For a library call whose host work outlasts its kernels
    (autograd's backward at 1024 tokens), where CUDA events time the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def bound_ms(nbytes: float, ops: float, kind: str, exps: float = 0.0):
    """Least time for the work: the largest of bytes over the HBM rate, ops
    over the peak for `kind`, and exp2 evaluations over EXP_PER_S."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": ops / PEAK_OPS[kind] * 1e3,
             "exp": exps / EXP_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def ptxas_instances(report: str) -> dict:
    """{kernel's mangled name: (registers, spill-store bytes)} from nvcc's
    -Xptxas -v report of one source."""
    out, name, spill = {}, None, 0
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], 0
        elif "bytes spill stores" in line and name:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name:
            out[name] = (int(line[line.index("Used"):].split()[1]), spill)
            name = None
    return out


def short_name(mangled: str) -> str:
    """attn_fwd_sm90<64,3,128,0,1> for the mangled name of a Hopper kernel
    instance (template arguments in order, bools as 0/1); the bare name of a
    kernel that is not a template."""
    m = re.search(r"([a-z_]+_sm90)I(.*?)EEv", mangled)
    if m is None:  # not a template
        m = re.search(r"([a-z_]+_sm90)E", mangled)
        return mangled if m is None else m.group(1)
    return f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2) + 'E'))}>"


def sass_functions(name: str) -> dict:
    """{kernel's mangled name: its SASS} from cuobjdump -sass of the built
    library of csrc/<name>.cu."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = str(kernels.library_path(name))
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    return {f.splitlines()[0].strip(): f for f in sass.split("Function : ")[1:]}


# check_sass(): the Hopper kernels each library must hold, and how many bf16
# mma.sync instances of each old kernel it may still hold
SASS_HOPPER = {
    "attention_wide": ("attn_fwd_sm90",),
    "attention_smalld": ("attn_fwd_sm90",),
    "attention_flash_bwd": ("flash_bwd_dkv_sm90", "flash_bwd_dq_sm90"),
    "attention_flash_bwd_wide": ("flash_bwd_ds_sm90", "flash_bwd_dq_gemm_sm90"),
}
SASS_OLD_BF16 = {
    "attention_wide": {"attn_fwd_kernel": 0},
    "attention_smalld": {"attn_fwd_kernel": 1},  # K1 at 128 < D <= 256
    "attention_flash_bwd": {"flash_bwd_dkv_kernel": 0, "flash_bwd_dq_kernel": 0},
    "attention_flash_bwd_wide": {"flash_bwd_dq_wide_kernel": 0,
                                 "flash_bwd_dkv_wide_kernel": 1},  # K4 at d = 512
}


def check_sass():
    """The Hopper kernels' instructions. Every bf16 instance of the attention
    forward (attn_fwd_sm90: K2 and K2r in attention_wide, K1 in
    attention_smalld), of K4 and K5 at D <= 128 (flash_bwd_dkv_sm90,
    flash_bwd_dq_sm90 in attention_flash_bwd) and of K5's two d = 512
    kernels (flash_bwd_ds_sm90, flash_bwd_dq_gemm_sm90 in
    attention_flash_bwd_wide) runs wgmma (HGMMA) and TMA loads (UTMALDG);
    no bf16 instance of the old mma.sync kernels (HMMA) is left for them to
    reach, but K1's for 128 < D <= 256 in attention_smalld, which must have
    K1's rules (kSmalld), and K4's at d = 512 (SASS_OLD_BF16)."""
    for lib, hopper in SASS_HOPPER.items():
        funcs = sass_functions(lib)
        for new_name in hopper:
            new = {n: (f.count("HGMMA"), f.count("UTMALDG")) for n, f in funcs.items()
                   if new_name in n}
            print(f"  SASS of {lib}: {len(new)} {new_name} instances, HGMMA / UTMALDG "
                  f"counts {sorted(new.values())}", flush=True)
            if not new or any(h == 0 or t == 0 for h, t in new.values()):
                fail(f"{lib}: a bf16 Hopper kernel {new_name} does not run wgmma and TMA")
            if lib == "attention_smalld" and any("ELb0ELb1EE" not in n for n in new):
                fail("attention_smalld holds a Hopper forward without K1's rules")
        for old_name, allowed in SASS_OLD_BF16[lib].items():
            old_bf16 = [n for n, f in funcs.items() if old_name in n and "HMMA" in f]
            print(f"  SASS of {lib}: bf16 mma.sync instances of {old_name}: "
                  f"{len(old_bf16)} (allowed {allowed})", flush=True)
            if len(old_bf16) != allowed:
                fail(f"{lib}: the old bf16 kernel {old_name} is still there to reach")
            # K1's mma.sync instance: <bf16, NT 32, kLse false, kSmalld true>, D > 128 only
            if lib == "attention_smalld" and any("Li32ELb0ELb1EE" not in n for n in old_bf16):
                fail("attention_smalld's mma.sync forward lacks K1's rules, or serves D <= 128")


# ------------------------------------------------------------------ survey

def unet_inputs(cfg: SwapConfig, seed: int, ctx_batch: int):
    """A batch-2 UNet input on the card: (x9, timesteps, context)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    hw = cfg.latent_size
    return (torch.randn((BATCH, 9, hw, hw), generator=g, device="cuda"),
            torch.randint(1, 1000, (BATCH,), generator=g, device="cuda"),
            torch.randn((ctx_batch, 1, 768), generator=g, device="cuda"))


def nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def survey(swapper, cfg: SwapConfig):
    """Kernel call shapes of the main path, as the kernel wrappers record
    them: K1 (BH, N, D) in one UNet forward with CFG dedup at batch 2, K2
    (BH, N, M, D) in one VAE encode and decode (one swap's), K3 (B, C, H, W)
    in one UNet forward at batch 2 of a fused copy with the same weights.
    Each total is held to PLANNED."""
    fused = UNetModel(dataclasses.replace(cfg.unet, fused_groupnorm=True), device="cuda")
    fused.load_state_dict(swapper.unet.state_dict())
    x9, t, ctx2 = unet_inputs(cfg, seed=3, ctx_batch=2 * BATCH)
    img = nchw(make_request(0, cfg.image_size, "cuda")["inpaint_image"])
    runs = (lambda: swapper.unet(x9, t, ctx2, cfg_expand=True),
            lambda: swapper.decode_latent(swapper.encode_latent(img)),
            lambda: fused(x9, t, ctx2[:BATCH]))
    found = []
    with torch.inference_mode():
        for kernel, run in zip(KERNELS, runs):
            kernel.shapes = collections.Counter()
            run()
            found.append(kernel.shapes)
            kernel.shapes = None
    torch.cuda.synchronize()
    for (what, want), shapes in zip(PLANNED.items(), found):
        if sum(shapes.values()) != want:
            fail(f"{what}: {sum(shapes.values())} launches at {dict(shapes)}, "
                 f"planned {want}")
    return found


# ------------------------------------------------------------------ phase 2

def errors(out, ref):
    """(max abs error, relative L2 error) of out against ref, in fp32."""
    diff = out.float() - ref.float()
    return diff.abs().max().item(), (diff.norm() / ref.float().norm()).item()


def within(name, kind, out, ref, dt):
    """Errors of a kernel's output against its plain version, and whether
    they are within the tolerance (bf16 also in relative L2)."""
    err, rel = errors(out, ref)
    ok = out.dtype == dt and err <= TOL[name][kind] and (kind == "fp32" or rel <= REL_TOL_BF16)
    return err, rel, ok


def ulp_bf16(ref) -> float:
    """One bf16 ulp (8 significant bits) at the largest magnitude of ref."""
    return 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)


def check_k2_function(q, k, v, scale, out):
    """bf16 K2 against the library's function: flash_attention_fwd_plain's o
    within K2_ULPS bf16 ulps of the largest |o|, and bit-equal to the
    residual forward's o (one kernel serves both entry points)."""
    ref = PA.flash_attention_fwd_plain(q, k, v, scale)[0]
    err = (out.float() - ref.float()).abs().max().item()
    lim = K2_ULPS * ulp_bf16(ref)
    same = torch.equal(out, PA.flash_attention_fwd(q, k, v, scale)[0])
    print(f"    K2 against flash_attention_fwd_plain's o: max_abs_err {err:.3e} (tol "
          f"{lim:.3e}, {K2_ULPS} bf16 ulp of max |o|); bit-equal to the residual "
          f"forward's o: {same}", flush=True)
    if not (err <= lim and same):
        fail("bf16 K2 is not the library forward's function")


def check_k1_function(q, k, v, scale, out, fast):
    """bf16 K1 against the TPU smalld kernel's own function: within K1_ULPS
    bf16 ulps of the largest |o| of smalld_attention_plain (the fixed
    first-256-key shift, or none when fast; the row sum of the rounded p).
    Returns the error."""
    ref = smalld_attention_plain(q, k, v, scale, fast)
    err = (out.float() - ref.float()).abs().max().item()
    lim = K1_ULPS * ulp_bf16(ref)
    print(f"    K1 against smalld_attention_plain{' (fast)' if fast else ''}: max_abs_err "
          f"{err:.3e} (tol {lim:.3e}, {K1_ULPS} bf16 ulp of max |o|)", flush=True)
    if not err <= lim:
        fail("bf16 K1 is not the TPU smalld kernel's function")
    return err


def check_attention(name, kernel, shapes, extra_shapes, gen):
    """Error of an attention kernel against einsum_attention, then bf16
    times at the main path's shapes. Returns the kernel's JSON entry.

    At each bf16 shape it also reads how far the plain version moves when
    its last key tile is dropped (64 keys for K1, the bf16 forward's kBN for
    K2), a fault the check must catch. bf16 K2 is held besides to the
    library's function (check_k2_function), bf16 K1 in both modes to the TPU
    kernel's (check_k1_function)."""
    worst = {"fp32": 0.0, "bf16": 0.0, "rel": 0.0, "own": 0.0}
    modes = (False, True) if name == "K1" else (False,)
    for shape in list(shapes) + [s for s in extra_shapes if s not in shapes]:
        bh, n, m, d = shape
        scale = d**-0.5
        for kind, dt in DTYPES.items():
            q = torch.randn(bh, n, d, generator=gen, device="cuda").to(dt)
            k = torch.randn(bh, m, d, generator=gen, device="cuda").to(dt)
            v = torch.randn(bh, m, d, generator=gen, device="cuda").to(dt)
            ref = einsum_attention(q, k, v, scale)
            for fast in modes:
                kw = {"fast": fast} if name == "K1" else {}
                out = kernel(q, k, v, scale=scale, **kw)
                torch.cuda.synchronize()
                err, rel, ok = within(name, kind, out, ref, dt)
                print(f"  {name} {kind} (BH,N,M,D)={shape}{' fast' if fast else ''}: "
                      f"max_abs_err {err:.3e} (tol {TOL[name][kind]:.0e}), rel L2 "
                      f"{rel:.3e}{f' (tol {REL_TOL_BF16:.0e})' if kind == 'bf16' else ''} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"{name} disagrees with its plain version at {shape} {kind}")
                worst[kind] = max(worst[kind], err)
                if kind == "bf16":
                    worst["rel"] = max(worst["rel"], rel)
                    if name == "K1":
                        worst["own"] = max(worst["own"],
                                           check_k1_function(q, k, v, scale, out, fast))
            if kind == "bf16":
                if name == "K2":
                    check_k2_function(q, k, v, scale, out)
                tile = 64 if name == "K1" else fwd_key_tile(d)
                dropped = einsum_attention(q, k[:, :-tile], v[:, :-tile], scale)
                f_err, f_rel, passes = within(name, kind, dropped, ref, dt)
                print(f"    the plain version with its last {tile}-key tile dropped: "
                      f"max_abs_err {f_err:.3e}, rel L2 {f_rel:.3e}: "
                      f"{'NOT CAUGHT' if passes else 'caught'}", flush=True)
                if passes:
                    fail(f"{name}'s bf16 tolerance would not catch a dropped key tile at {shape}")
    total = collections.Counter()
    for (bh, n, m, d), count in shapes.items():
        q = torch.randn(bh, n, d, generator=gen, device="cuda", dtype=torch.bfloat16)
        k = torch.randn(bh, m, d, generator=gen, device="cuda", dtype=torch.bfloat16)
        v = torch.randn(bh, m, d, generator=gen, device="cuda", dtype=torch.bfloat16)
        scale = d**-0.5
        ms = time_ms(lambda: kernel(q, k, v, scale=scale))
        plain = time_ms(lambda: einsum_attention(q, k, v, scale))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], scale=scale))
        nbytes = 2 * (2 * bh * n * d + 2 * bh * m * d)  # q, k, v in; o out
        ops = 4.0 * bh * n * m * d  # QK^T and PV, 2 ops per multiply-add
        exps = float(bh * n * m)  # one exp2 a score
        b, by = bound_ms(nbytes, ops, "bf16", exps)
        print(f"  {name} bf16 (BH,N,M,D)=({bh},{n},{m},{d}) x{count}: kernel {ms:.4f} ms, "
              f"bound {b:.4f} ms ({by}), plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
              f"{ops / ms / 1e9:.1f} TFLOP/s", flush=True)
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", b), ("ops", ops), ("bytes", nbytes), ("exps", exps)):
            total[key] += count * val
    _, by = bound_ms(total["bytes"], total["ops"], "bf16", total["exps"])
    entry = {"max_abs_err": worst["bf16"], "max_abs_err_fp32": worst["fp32"],
             "rel_l2_err": worst["rel"],
             "tol": TOL[name]["bf16"], "ms": total["ms"], "plain_ms": total["plain_ms"],
             "bound_ms": total["bound_ms"], "bound_by": by,
             "library_ms": total["library_ms"]}
    if name == "K1":
        entry["max_abs_err_vs_smalld_attention_plain"] = worst["own"]
    return entry


def time_k1_wide(gen):
    """bf16 K1 at d = 160 (the mma.sync instance with K1's rules), off the
    512 px main path: its time beside its bound, smalld_attention_plain and
    sdpa at K1_WIDE_SHAPES[0]."""
    bh, n, m, d = K1_WIDE_SHAPES[0]
    q, k, v = (torch.randn(bh, n, d, generator=gen, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    scale = d**-0.5
    ms = time_ms(lambda: self_attention_smalld(q, k, v, scale=scale))
    plain = time_ms(lambda: smalld_attention_plain(q, k, v, scale))
    lib = time_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=scale))
    # the prologue's QK^T over the first 256 keys is not counted: it is the kernel's choice
    b, by = bound_ms(2 * 4 * bh * n * d, 4.0 * bh * n * m * d, "bf16", float(bh * n * m))
    print(f"  K1 bf16 (BH,N,M,D)={K1_WIDE_SHAPES[0]} (off the main path): kernel {ms:.4f} ms, "
          f"bound {b:.4f} ms ({by}), plain {plain:.4f} ms, sdpa {lib:.4f} ms", flush=True)
    return {"shape": K1_WIDE_SHAPES[0], "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": b, "bound_by": by}


def check_groupnorm(shapes, gen):
    """K3 against group_norm_silu_plain at each (B,C,H,W) of the fused UNet
    forward (eps 1e-5, SiLU), plus eps 1e-6 without SiLU; bf16 times."""
    worst = {"fp32": 0.0, "bf16": 0.0, "rel": 0.0}
    total = collections.Counter()
    for shape, count in shapes.items():
        c = shape[1]
        scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        for kind, dt in DTYPES.items():
            x = (2.0 * torch.randn(shape, generator=gen, device="cuda") + 0.5).to(dt)
            for eps, silu in ((1e-5, True), (1e-6, False)):
                out = group_norm_silu(x, scale, bias, 32, eps, silu)
                torch.cuda.synchronize()
                ref = group_norm_silu_plain(x, scale, bias, 32, eps, silu)
                err, rel, ok = within("K3", kind, out, ref, dt)
                if not ok:
                    fail(f"K3 disagrees with its plain version at {shape} {kind} "
                         f"eps={eps} silu={silu}: {err:.3e}, rel L2 {rel:.3e}")
                worst[kind] = max(worst[kind], err)
                if kind == "bf16":
                    worst["rel"] = max(worst["rel"], rel)
        x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        ms = time_ms(lambda: group_norm_silu(x, scale, bias, 32, 1e-5, True))
        plain = time_ms(lambda: group_norm_silu_plain(x, scale, bias, 32, 1e-5, True))
        sb, bb = scale.to(x.dtype), bias.to(x.dtype)
        lib = time_ms(lambda: F.silu(F.group_norm(x, 32, sb, bb, 1e-5)))
        nbytes = 2 * x.numel() * 2 + 2 * c * 4
        ops = 10.0 * x.numel()  # stats, normalise, affine, SiLU: fp32 outside the tensor cores
        b, by = bound_ms(nbytes, ops, "fp32")
        print(f"  K3 bf16 (B,C,H,W)={shape} x{count}: kernel {ms:.4f} ms, bound "
              f"{b:.4f} ms ({by}), plain {plain:.4f} ms, group_norm+silu {lib:.4f} ms, "
              f"{nbytes / ms / 1e6:.0f} GB/s", flush=True)
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", b), ("ops", ops), ("bytes", nbytes)):
            total[key] += count * val
    print(f"  K3 max_abs_err fp32 {worst['fp32']:.3e} (tol {TOL['K3']['fp32']:.0e}), "
          f"bf16 {worst['bf16']:.3e} (tol {TOL['K3']['bf16']:.3e}), bf16 rel L2 "
          f"{worst['rel']:.3e} (tol {REL_TOL_BF16:.0e}) ok", flush=True)
    _, by = bound_ms(total["bytes"], total["ops"], "fp32")
    return {"max_abs_err": worst["bf16"], "max_abs_err_fp32": worst["fp32"],
            "rel_l2_err": worst["rel"], "tol": TOL["K3"]["bf16"], "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"], "bound_by": by,
            "library_ms": total["library_ms"]}


# ------------------------------------------------------------------ phases 3-5

def make_request(r: int, size: int, dev, batch: int = BATCH):
    """A pre-cropped batch, different for every r: NHWC images in [-1,1],
    mask 1 = keep with a hole over the face, CLIP-normalised source crop,
    68 landmarks in pixels."""
    g = torch.Generator(device=dev).manual_seed(1000 + r)
    target = torch.rand((batch, size, size, 3), generator=g, device=dev) * 2 - 1
    mask = torch.ones((batch, size, size, 1), device=dev)
    lo = size // 4 + (r % 4) * size // 32
    mask[:, lo: lo + size // 2, size // 4: 3 * size // 4] = 0.0
    return dict(
        target_image=target,
        inpaint_image=target * mask,
        inpaint_mask=mask,
        ref_clip224=torch.randn((batch, 224, 224, 3), generator=g, device=dev),
        landmarks=torch.rand((batch, 136), generator=g, device=dev) * size,
    )


def build_swapper(cfg: SwapConfig):
    """FaceSwapper on the card with seeded random weights, the reference's
    zero-initialised layers re-randomised."""
    t0 = time.perf_counter()
    swapper = FaceSwapper(cfg, device="cuda")
    for i, m in enumerate(swapper.towers().values()):
        init_params(m, seed=i, dezero=True)
    n_unet = sum(p.numel() for p in swapper.unet.parameters())
    if n_unet != UNET_PARAMS:
        fail(f"UNet has {n_unet} parameters, expected {UNET_PARAMS}")
    torch.cuda.synchronize()
    print(f"  built SwapConfig() towers on the card in {time.perf_counter() - t0:.1f} s "
          f"(UNet {n_unet:,} params, bf16)", flush=True)
    return swapper


def serve(swapper, cfg: SwapConfig, k1_per_forward: int, k2_per_swap: int):
    dev = torch.device("cuda")
    want_k1 = cfg.ddim_steps * k1_per_forward
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path's run starts here
    lat = []
    for r in range(REQUESTS):
        before = counts()
        req = make_request(r, cfg.image_size, dev)
        t0 = time.perf_counter()
        out = swapper.swap(**req, generator=torch.Generator(device=dev).manual_seed(r))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        d = [a - b for a, b in zip(counts(), before)]
        ok = (out.shape == (BATCH, cfg.image_size, cfg.image_size, 3)
              and out.dtype == torch.float32 and bool(torch.isfinite(out).all())
              and float(out.abs().max()) <= 1.0)
        print(f"  request {r}: {lat[-1]:.3f} s, out {tuple(out.shape)} finite/in [-1,1] "
              f"{ok}, std {out.float().std().item():.4f}, launches K1 +{d[0]} K2 +{d[1]} "
              f"K3 +{d[2]}", flush=True)
        if not ok:
            fail(f"request {r}: output not finite (B,512,512,3) in [-1,1]")
        if d[0] != want_k1 or d[1] != k2_per_swap:
            fail(f"request {r}: K1 launched {d[0]} times (want {want_k1}), "
                 f"K2 {d[1]} (want {k2_per_swap})")
    main_launches = counts()
    peak = torch.cuda.max_memory_allocated()
    steady = lat[1:] or lat
    print(f"  latency first {lat[0]:.3f} s (includes warm-up), steady mean "
          f"{sum(steady) / len(steady):.3f} s; {BATCH * len(steady) / sum(steady):.3f} "
          f"swaps/s; peak memory {peak / 2**30:.2f} GiB", flush=True)

    # host cost of the eager loop: one dedup UNet forward, enqueue vs device
    x9, t, ctx2 = unet_inputs(cfg, seed=7, ctx_batch=2 * BATCH)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        swapper.unet(x9, t, ctx2, cfg_expand=True)
        host = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
    print(f"  one UNet forward (dedup, batch {BATCH}): host enqueue {host:.2f} ms, "
          f"device {a.elapsed_time(b):.2f} ms", flush=True)
    profile_forward(lambda: swapper.unet(x9, t, ctx2, cfg_expand=True))
    return main_launches, lat, peak


def profile_forward(fn, top: int = 8, what: str = "forward", grad: bool = False):
    """torch.profiler over one call: the device kernels' time by kind and
    the longest kernels. The profiler slows the host, so the share of the
    call's time the device was busy is taken against an unprofiled run.
    grad=True runs fn with autograd on (a training step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(not grad):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    dev = lambda e: e.self_device_time_total / 1e3  # us -> ms
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev(e) > 0),
                  key=dev, reverse=True)
    kinds = collections.Counter()
    for e in rows:
        name = e.key
        kind = ("K2/K2r d=512 attn_fwd_sm90" if "attn_fwd_sm90<512" in name else
                "K1 attn_fwd_sm90" if "attn_fwd_sm90" in name and "false, true>" in name else
                "K2/K2r attn_fwd_sm90" if "attn_fwd_sm90" in name else
                "K1 attn_fwd_kernel" if "attn_fwd_kernel" in name else
                "K4 d=512 flash_bwd_dkv_wide" if "flash_bwd_dkv_wide" in name else
                "K5 d=512" if any(w in name for w in ("flash_bwd_dq_wide", "flash_bwd_ds_sm90",
                                                      "flash_bwd_dq_gemm_sm90")) else
                "K4 flash_bwd_dkv" if "flash_bwd_dkv" in name else
                "K5 flash_bwd_dq" if "flash_bwd_dq" in name else
                "K3 gn_" if "gn_partial" in name or "gn_apply" in name else
                "cuDNN NCHW<->NHWC" if "nchwToNhwc" in name or "nhwcToNchw" in name else
                "conv/gemm" if any(w in name for w in ("conv", "gemm", "sm90", "xmma", "cutlass", "dgrad", "implicit")) else
                "other")
        kinds[kind] += dev(e)
    busy = sum(kinds.values())
    print(f"  profile of that {what}: device kernels {busy:.2f} ms against "
          f"{wall:.2f} ms wall unprofiled ({100 * busy / wall:.1f}% busy), "
          f"{sum(e.count for e in rows)} kernel launches; by kind: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.most_common()), flush=True)
    for e in rows[:top]:
        print(f"    {dev(e):8.3f} ms {e.count:5d}x  {e.key[:90]}", flush=True)


def fp32_copy(module, cls, config):
    """An fp32 `cls(config)` on the card holding `module`'s weights."""
    net = cls(config, device="cuda")
    net.load_state_dict(module.state_dict())
    return net.eval().requires_grad_(False)


def towers_vs_fp32(swapper, cfg: SwapConfig, k3_per_forward: int):
    """Each bf16 tower against an fp32 copy with the same weights, at full
    width: the UNet unfused and fused (K3), the VAE encoder (posterior mean)
    and decoder (fed the same latent), the conditioner. Returns the fused
    forward's K3 launches."""
    f32 = torch.float32
    rp = dataclasses.replace
    cond = cfg.conditioner
    fused = fp32_copy(swapper.unet, UNetModel, rp(cfg.unet, fused_groupnorm=True))
    unet32 = fp32_copy(swapper.unet, UNetModel, rp(cfg.unet, dtype=f32))
    vae32 = fp32_copy(swapper.vae, AutoencoderKL, rp(cfg.vae, dtype=f32))
    cond32 = fp32_copy(swapper.conditioner, REFaceConditioner,
                       rp(cond, clip=rp(cond.clip, dtype=f32),
                          arcface=rp(cond.arcface, dtype=f32)))
    x9, t, ctx = unet_inputs(cfg, seed=11, ctx_batch=BATCH)
    req = make_request(6, cfg.image_size, "cuda")
    img, ref, target = (nchw(req[k]) for k in ("inpaint_image", "ref_clip224", "target_image"))
    got = {}
    with torch.inference_mode():
        plain = swapper.unet(x9, t, ctx)
        ref32 = unet32(x9, t, ctx)
        reset_counts()  # the fused path's run
        out_fused = fused(x9, t, ctx)
        torch.cuda.synchronize()
        k3 = group_norm_silu.launches
        got["UNet"], got["UNet fused"] = (plain, ref32), (out_fused, ref32)
        z32 = vae32.encode(img).mode()
        got["VAE encode"] = (swapper.vae.encode(img).mode(), z32)
        got["VAE decode"] = (swapper.vae.decode(z32), vae32.decode(z32))
        c16, _ = swapper.build_context(ref, target, req["landmarks"])
        got["conditioner"] = (c16, cond32(ref, clip_normalize(un_norm(target)), req["landmarks"]))
        ms = {name: time_ms(lambda: net(x9, t, ctx), budget_ms=500.0)
              for name, net in (("unfused", swapper.unet), ("fused", fused))}
    print(f"  UNet forward at batch {BATCH}: unfused {ms['unfused']:.2f} ms, fused "
          f"{ms['fused']:.2f} ms (CUDA events, host enqueue included); fused vs unfused "
          f"bf16 rel L2 {errors(out_fused, plain)[1]:.4e}; K3 launches {k3}", flush=True)
    bad = []
    for name, (out, want) in got.items():
        err, rel = errors(out, want)
        ok = bool(torch.isfinite(out).all()) and rel <= TOWER_TOL[name]
        print(f"  {name} bf16 {tuple(out.shape)} vs fp32: rel L2 {rel:.4e} "
              f"(tol {TOWER_TOL[name]:.0e}), max abs {err:.4e} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            bad.append(name)
    if k3 != k3_per_forward:
        fail(f"K3 launched {k3} times in the fused forward, expected {k3_per_forward}")
    if bad:
        fail(f"bf16 further from fp32 than the tolerance: {', '.join(bad)}")
    return k3


def tiny_reference():
    """tiny_swap_config at 256 px, fp32, fused GroupNorm, with a VAE whose
    mid-block is 512 wide as the real one (a head of d <= 256 would route to
    K1): the card (K1 at 1024 tokens of d=8, K2 at 1024 tokens of d=512, K3)
    against the port on the CPU (plain versions), same weights and inputs,
    x_T fixed, no random draw."""
    base = tiny_swap_config(image_size=256, ddim_steps=2)
    cfg = dataclasses.replace(
        base, sample_posterior=False,
        unet=dataclasses.replace(base.unet, fused_groupnorm=True),
        vae=dataclasses.replace(base.vae, ch=32, ch_mult=(1, 2, 4, 16)))
    card = FaceSwapper(cfg, device="cuda")
    for i, m in enumerate(card.towers().values()):
        init_params(m, seed=20 + i, dezero=True)
    cpu = FaceSwapper(cfg, device="cpu")
    cpu.load_params({name: {k: v.cpu() for k, v in m.state_dict().items()}
                     for name, m in card.towers().items()})
    req = make_request(5, 256, "cpu")
    req["x_T"] = torch.randn((BATCH, 32, 32, 4), generator=torch.Generator().manual_seed(5))
    reset_counts()
    out = card.swap(**{k: v.cuda() for k, v in req.items()})
    torch.cuda.synchronize()
    launched = counts()
    ref = cpu.swap(**req)
    err = (out.cpu() - ref).abs().max().item()
    inside = (ref.abs() < 0.99).float().mean().item()
    print(f"  tiny 256 px swap, card vs CPU: max abs err {err:.3e} (tol 1e-3), "
          f"{inside:.2f} of pixels off the clamp, launches K1 {launched[0]} "
          f"K2 {launched[1]} K3 {launched[2]}", flush=True)
    if min(launched[:3]) == 0:
        fail("the tiny reference run did not reach every kernel")
    if not err <= 1e-3:
        fail("the card's tiny swap disagrees with the CPU port")


# ------------------------------------------------------------------ phase 6

def check_ds_workspace(ws, q, k, v, lse, do, di, scale):
    """bf16 K5's dS workspace at d > 128 against the plain dS rounded to
    bf16 (`_probs_and_ds`, the value the library rounds for its dQ product):
    within one bf16 ulp of the largest |dS| at keys below M, and exactly 0
    at keys in [M, ds_pitch(M))."""
    m = k.shape[1]
    ref = PA._probs_and_ds(q, k, v, lse, do, di, scale)[1].to(torch.bfloat16)
    err = (ws[..., :m].float() - ref.float()).abs().max().item()
    lim = ulp_bf16(ref)
    pad = ws[..., m:]
    zeros = bool((pad == 0).all())
    print(f"    flash_bwd_dq's dS workspace {tuple(ws.shape)} against the plain dS in "
          f"bf16: max_abs_err {err:.3e} (tol {lim:.3e}, one bf16 ulp of max |dS|); the "
          f"{pad.shape[-1]} keys past M hold 0: {zeros}", flush=True)
    if not (err <= lim and zeros):
        fail("bf16 K5's dS workspace is not the plain dS rounded to bf16")


def check_train_kernels(gen, shapes):
    """The residual forward (o, lse), K4 (dk, dv) and K5 (dq) against their
    plain versions at `shapes`, bf16 and fp32 (the backward kernels and
    their plain versions get the same plain o and lse). Returns the worst
    errors by kernel.

    At each bf16 shape it also reads three faults the limits must catch:
    the plain forward's o with its last key tile dropped (the bf16
    forward's kBN keys), the plain dV with its last 64-key tile dropped,
    and the plain dQ without the last 64 keys' contribution. At d > 128 in
    bf16 K5 writes its dS workspace into a tensor filled with NaN, which
    check_ds_workspace then holds to the plain dS."""
    worst = {k: {"fp32": 0.0, "bf16": 0.0, "rel": 0.0} for k in ("K2r", "K4", "K5")}
    worst_lse = 0.0

    def hold(key, kind, out, ref, dt, label):
        err, rel, ok = within(key, kind, out, ref, dt)
        print(f"    {label} {kind}: max_abs_err {err:.3e} (tol {TOL[key][kind]:.0e}), "
              f"rel L2 {rel:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{label} disagrees with its plain version ({kind})")
        worst[key][kind] = max(worst[key][kind], err)
        if kind == "bf16":
            worst[key]["rel"] = max(worst[key]["rel"], rel)

    for bh, n, m, d in shapes:
        scale = d**-0.5
        for kind, dt in DTYPES.items():
            print(f"  (BH,N,M,D)=({bh},{n},{m},{d})", flush=True)
            q, k, v, do = (torch.randn(bh, x, d, generator=gen, device="cuda").to(dt)
                           for x in (n, m, m, n))
            o, lse = PA.flash_attention_fwd(q, k, v, scale)
            torch.cuda.synchronize()
            o_ref, lse_ref = PA.flash_attention_fwd_plain(q, k, v, scale)
            hold("K2r", kind, o, o_ref, dt, "flash_attention_fwd o")
            lse_err = (lse - lse_ref).abs().max().item()
            print(f"    flash_attention_fwd lse {kind}: max_abs_err {lse_err:.3e} "
                  f"(tol {LSE_TOL:.0e})", flush=True)
            if lse.dtype != torch.float32 or not lse_err <= LSE_TOL:
                fail(f"flash_attention_fwd's lse disagrees with its plain version ({kind})")
            worst_lse = max(worst_lse, lse_err)
            del o, lse
            di = PA.row_dot(o_ref, do)
            dk, dv = PA.flash_bwd_dkv(q, k, v, lse_ref, do, di, scale)
            ws = None
            if kind == "bf16" and d > 128:  # NaN shows any element left unwritten
                ws = torch.full((bh, n, PA.ds_pitch(m)), math.nan, dtype=dt, device="cuda")
            dq = PA.flash_bwd_dq(q, k, v, lse_ref, do, di, scale, workspace=ws)
            torch.cuda.synchronize()
            if ws is not None:
                check_ds_workspace(ws, q, k, v, lse_ref, do, di, scale)
                del ws
            dk_ref, dv_ref = PA.flash_bwd_dkv_plain(q, k, v, lse_ref, do, di, scale)
            hold("K4", kind, dk, dk_ref, dt, "flash_bwd_dkv dk")
            hold("K4", kind, dv, dv_ref, dt, "flash_bwd_dkv dv")
            del dk, dv, dk_ref
            dq_ref = PA.flash_bwd_dq_plain(q, k, v, lse_ref, do, di, scale)
            hold("K5", kind, dq, dq_ref, dt, "flash_bwd_dq dq")
            if kind == "bf16":
                tile = fwd_key_tile(d)
                bad_o = PA.flash_attention_fwd_plain(q, k[:, :-tile], v[:, :-tile], scale)[0]
                bad_dv = dv_ref.clone()
                bad_dv[:, -64:] = 0
                bad_dq = PA.flash_bwd_dq_plain(q, k[:, :-64], v[:, :-64], lse_ref, do, di, scale)
                for key, bad, ref, what in (("K2r", bad_o, o_ref, f"forward's o with its last {tile}-key tile dropped"),
                                            ("K4", bad_dv, dv_ref, "dV with its last 64-key tile dropped"),
                                            ("K5", bad_dq, dq_ref, "dQ without the last 64 keys")):
                    f_err, f_rel, passes = within(key, kind, bad, ref, dt)
                    print(f"    the plain {what}: max_abs_err {f_err:.3e}, rel L2 "
                          f"{f_rel:.3e}: {'NOT CAUGHT' if passes else 'caught'}", flush=True)
                    if passes:
                        fail(f"{key}'s bf16 tolerance would not catch the {what}")
                del bad_o, bad_dv, bad_dq
            del q, k, v, do, o_ref, lse_ref, di, dq, dq_ref, dv_ref
            torch.cuda.empty_cache()

    print(f"  worst max_abs_err: " + ", ".join(
        f"{k} fp32 {w['fp32']:.3e} bf16 {w['bf16']:.3e} (rel L2 {w['rel']:.3e})"
        for k, w in worst.items()) + f"; lse {worst_lse:.3e}", flush=True)
    return worst


def time_train_kernels(gen, shapes):
    """bf16 times of the residual forward, K4 and K5 at `shapes`, each beside
    its bound, its plain version and scaled_dot_product_attention: its
    forward for K2r; for K4 and K5 its backward alone (one forward kept, then
    torch.autograd.grad with retain_graph=True: dq, dk and dv together, the
    work of K4 and K5 together), by CUDA events and by the profiler's device
    time (device_ms), and beside it one forward and backward, the yardstick
    of PRs 2-4. K5's bytes at d > 128 count its dS workspace, written and
    read once. Returns {key: {shape: stats}} for the JSON rows."""
    stats = {"K2r": {}, "K4": {}, "K5": {}}
    for bh, n, m, d in shapes:
        scale = d**-0.5
        q, k, v, do = (torch.randn(bh, x, d, generator=gen, device="cuda", dtype=torch.bfloat16)
                       for x in (n, m, m, n))
        o, lse = PA.flash_attention_fwd(q, k, v, scale)
        di = PA.row_dot(o, do)
        qg, kg, vg = (t[None].detach().requires_grad_() for t in (q, k, v))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
            torch.autograd.grad(out, (qg, kg, vg), do[None])

        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=scale))
        sdpa_fb = time_ms(sdpa_fwd_bwd)
        kept = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        bwd = lambda: torch.autograd.grad(kept, (qg, kg, vg), do[None], retain_graph=True)
        sdpa_bwd, sdpa_bwd_dev = time_ms(bwd), device_ms(bwd)
        del kept, bwd
        lse_b = 4 * bh * n
        ws_b = 4 * bh * n * PA.ds_pitch(m) if d > 128 else 0  # K5's dS, written and read
        io = lambda *sizes: 2 * sum(bh * x * d for x in sizes)  # bf16 operands
        exps = float(bh * n * m)  # one exp2 a score, in the forward and in each backward kernel
        rows = {
            "K2r": (lambda: PA.flash_attention_fwd(q, k, v, scale),
                    lambda: PA.flash_attention_fwd_plain(q, k, v, scale),
                    4.0 * bh * n * m * d, io(n, m, m, n) + lse_b, sdpa_fwd),
            "K4": (lambda: PA.flash_bwd_dkv(q, k, v, lse, do, di, scale),
                   lambda: PA.flash_bwd_dkv_plain(q, k, v, lse, do, di, scale),
                   8.0 * bh * n * m * d, io(n, m, m, n, m, m) + 2 * lse_b, sdpa_bwd),
            "K5": (lambda: PA.flash_bwd_dq(q, k, v, lse, do, di, scale),
                   lambda: PA.flash_bwd_dq_plain(q, k, v, lse, do, di, scale),
                   6.0 * bh * n * m * d, io(n, m, m, n, n) + 2 * lse_b + ws_b, sdpa_bwd),
        }
        for key, (kern, plain, ops, nbytes, lib) in rows.items():
            ms, plain_ms = time_ms(kern), time_ms(plain)
            b, by = bound_ms(nbytes, ops, "bf16", exps)
            stats[key][(bh, n, m, d)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                                             bound_ms=b, ops=ops, bytes=nbytes, exps=exps)
            fb = ""
            if key != "K2r":
                stats[key][(bh, n, m, d)].update(library_device_ms=sdpa_bwd_dev,
                                                 library_fwd_bwd_ms=sdpa_fb)
                fb = (f" ({sdpa_bwd_dev:.4f} ms of device time; forward+backward "
                      f"{sdpa_fb:.4f} ms)")
            print(f"  {key} bf16 (BH,N,M,D)=({bh},{n},{m},{d}): kernel {ms:.4f} ms, bound "
                  f"{b:.4f} ms ({by}), plain {plain_ms:.4f} ms, sdpa "
                  f"{'forward' if key == 'K2r' else 'backward alone'} {lib:.4f} ms{fb}, "
                  f"{ops / ms / 1e9:.1f} TFLOP/s", flush=True)
        del q, k, v, do, o, lse, di, qg, kg, vg
        torch.cuda.empty_cache()
    return stats


# ------------------------------------------------------------------ phase 7

def set_unet_attn(unet, impl: str):
    for m in unet.modules():
        if isinstance(m, CrossAttention):
            m.attn_impl = impl


def grads_of(loss_fn, modules, batch, draws):
    """(loss, {name: grad}) of one eps-MSE loss over the UNet's parameters."""
    for p in modules.unet.parameters():
        p.grad = None
    loss, _ = loss_fn(modules, batch, draws)
    loss.backward()
    return loss.item(), {k: p.grad.float().clone() for k, p in modules.unet.named_parameters()
                         if p.grad is not None}


def rel_l2(a: dict, b: dict) -> float:
    num = sum((a[k] - b[k]).double().pow(2).sum() for k in b)
    return float((num / sum(v.double().pow(2).sum() for v in b.values())).sqrt())


def train_path():
    """The eps-MSE step at full width (phase 7). Returns (launches of the
    main path in KERNELS order, kernel shapes per step, step times, peak)."""
    cfg = SwapConfig()
    # warmup_steps=1: the optimizer's learning rate reaches 1e-5 at the
    # second step, so that every trainable parameter moves by far more than
    # its fp32 resolution (the default 10k-step warmup starts at 1e-11)
    tcfg = TrainConfig(warmup_steps=1)
    train_step, loss_fn, init_state = make_train_step(cfg, tcfg, device="cuda")
    t0 = time.perf_counter()
    state = init_state(seed=0)
    for i, m in enumerate(state.modules.towers().values()):
        init_params(m, seed=i, dezero=True)  # gradients reach every layer
    named = named_params(state.modules)
    labels = trainable_labels(named)
    n_unet = sum(p.numel() for p in state.modules.unet.parameters())
    n_train = sum(p.numel() for k, p in named.items() if labels[k] == "train")
    if n_unet != UNET_PARAMS:
        fail(f"UNet has {n_unet} parameters, expected {UNET_PARAMS}")
    torch.cuda.synchronize()
    print(f"  built the training towers in {time.perf_counter() - t0:.1f} s: {n_train:,} "
          f"trainable parameters (fp32), UNet remat {state.modules.unet.config.remat}, "
          f"attn_impl {state.modules.unet.config.attn_impl!r}", flush=True)
    hw = cfg.latent_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [make_request(200 + s, cfg.image_size, "cuda", batch=TRAIN_BATCH)
               for s in range(TRAIN_STEPS)]
    draws = [make_draws(TRAIN_BATCH, hw, tcfg, "cuda", gen) for _ in range(TRAIN_STEPS)]
    draws[0]["drop"][0] = True  # the null token gets a gradient
    snapshot = {k: p.detach().clone() for k, p in named.items()}
    train_kernels = KERNELS[3:]
    shapes = {kern.__name__: collections.Counter() for kern in train_kernels}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the training path's run starts here
    times, losses = [], []
    for s in range(TRAIN_STEPS):
        before = counts()
        if s == 0:
            for kern in train_kernels:
                kern.shapes = shapes[kern.__name__]
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, metrics = train_step(state, batches[s], draws[s])
        b.record()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for kern in train_kernels:
            kern.shapes = None
        losses.append(metrics["loss"].item())
        times.append(wall)
        d = tuple(x - y for x, y in zip(counts(), before))
        print(f"  step {s}: loss {losses[-1]:.5f}, {wall:.3f} s (host enqueue {host:.1f} ms, "
              f"device {a.elapsed_time(b):.1f} ms), launches K1 +{d[0]} K2 +{d[1]} K3 +{d[2]} "
              f"K2-residual +{d[3]} K4 +{d[4]} K5 +{d[5]}", flush=True)
        if d != TRAIN_PLAN:
            fail(f"step {s}: launches {d}, planned {TRAIN_PLAN} (K1, K2, K3, K2 with "
                 "residuals, K4, K5)")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(map(math.isfinite, losses)):
        fail(f"a loss is not finite: {losses}")
    print("  kernel shapes in step 0 as the wrappers recorded them: "
          + "; ".join(f"{k} {dict(c)}" for k, c in shapes.items()), flush=True)
    for kern, per_step in zip(train_kernels, TRAIN_PLAN[3:]):
        plan = {shape: per_step // len(TRAIN_SHAPES) for shape in TRAIN_SHAPES}
        if dict(shapes[kern.__name__]) != plan:
            fail(f"{kern.__name__} ran at {dict(shapes[kern.__name__])}, planned {plan}")
    moved = [k for k, p in named.items() if not torch.equal(p, snapshot[k])]
    stuck = [k for k in moved if labels[k] == "freeze"] + [
        k for k in named if labels[k] == "train" and k not in moved]
    print(f"  after {TRAIN_STEPS} steps: {sum(labels[k] == 'train' for k in moved)} of "
          f"{sum(v == 'train' for v in labels.values())} trainable tensors moved, "
          f"{sum(labels[k] == 'freeze' for k in moved)} of "
          f"{sum(v == 'freeze' for v in labels.values())} frozen ones did", flush=True)
    if stuck:
        fail(f"trainable tensors that did not move or frozen ones that did: {stuck[:8]}")
    del snapshot
    steady = times[1:]
    print(f"  step time first {times[0]:.3f} s (warm-up included), steady "
          f"{sum(steady) / len(steady):.3f} s; peak memory {peak / 2**30:.2f} GiB", flush=True)
    profile_forward(lambda: train_step(state, batches[0], draws[0]), what="training step",
                    grad=True)

    # the same step with the plain attention product (autograd) on the card
    loss_f, g_f = grads_of(loss_fn, state.modules, batches[0], draws[0])
    set_unet_attn(state.modules.unet, "einsum")
    before = counts()
    loss_e, g_e = grads_of(loss_fn, state.modules, batches[0], draws[0])
    flash_runs = sum(counts()[3:]) - sum(before[3:])
    set_unet_attn(state.modules.unet, "flash")
    rel_loss, rel_grad = abs(loss_f - loss_e) / abs(loss_e), rel_l2(g_f, g_e)
    print(f"  flash vs einsum attention, one step (bf16): loss {loss_f:.6f} vs {loss_e:.6f} "
          f"(rel {rel_loss:.3e}, tol {TRAIN_TOL['loss']:.0e}), UNet gradient rel L2 "
          f"{rel_grad:.3e} (tol {TRAIN_TOL['grad']:.0e}); flash launches in the einsum "
          f"run {flash_runs}", flush=True)
    if flash_runs or not (rel_loss <= TRAIN_TOL["loss"] and rel_grad <= TRAIN_TOL["grad"]):
        fail("the flash step disagrees with the einsum step")
    del state, g_f, g_e
    torch.cuda.empty_cache()
    return launches, shapes, times, peak


def tiny_train_reference(recon=None):
    """tiny_swap_config at 256 px, fp32: the loss and every trainable
    gradient on the card against the CPU port (plain versions), same weights,
    batch and draws. recon=None: the eps-MSE step (the UNet's self-attention
    at 1024 tokens of d=8 runs the flash kernels). With a ReconLossConfig:
    the full loss, with a VAE whose mid-block is 512 wide as the real one, so
    that the decodes under autograd run the flash kernels at d=512 too."""
    cfg = tiny_swap_config(image_size=256)
    if recon is not None:
        cfg = dataclasses.replace(cfg, vae=dataclasses.replace(
            cfg.vae, ch=32, ch_mult=(1, 2, 4, 16)))
    tcfg = TrainConfig()
    card_step, _, card_init = make_train_step(cfg, tcfg, recon=recon, device="cuda")
    cpu_step, _, cpu_init = make_train_step(cfg, tcfg, recon=recon, device="cpu")
    card = card_init(seed=30)
    for i, m in enumerate(card.modules.towers().values()):
        init_params(m, seed=30 + i, dezero=True)
    cpu = cpu_init({name: {k: v.cpu() for k, v in m.state_dict().items()}
                    for name, m in card.modules.towers().items()})
    batch = make_request(9, 256, "cpu")
    draws = make_draws(BATCH, 32, tcfg, "cpu", torch.Generator().manual_seed(3))
    draws["drop"][0] = True
    train_kernels = KERNELS[3:]
    for kern in train_kernels:
        kern.shapes = collections.Counter()
    reset_counts()
    loss_c, metrics_c = card_step.loss_and_grads(
        card.modules, {k: v.cuda() for k, v in batch.items()},
        {k: v.cuda() for k, v in draws.items()})
    torch.cuda.synchronize()
    launched = counts()
    widths = [sorted({shape[3] for shape in kern.shapes}) for kern in train_kernels]
    for kern in train_kernels:
        kern.shapes = None
    loss_p, metrics_p = cpu_step.loss_and_grads(cpu.modules, batch, draws)
    grads = lambda st: {k: p.grad.cpu() for k, p in named_params(st.modules).items()
                        if p.grad is not None}
    gc, gp = grads(card), grads(cpu)
    total = sum(float(g.double().pow(2).sum()) for g in gp.values()) ** 0.5
    worst = max(float((gc[k] - g).norm()) / max(float(g.norm()), 1e-3 * total)
                for k, g in gp.items())
    rel_loss = abs(loss_c.item() - loss_p.item()) / abs(loss_p.item())
    rel_metrics = max(abs(metrics_c[k].item() - v.item()) / abs(v.item())
                      for k, v in metrics_p.items())
    what = "eps-MSE step" if recon is None else "full-loss step"
    print(f"  tiny 256 px {what}, card vs CPU (fp32): loss rel {rel_loss:.3e}, metrics "
          f"{sorted(metrics_p)} rel {rel_metrics:.3e} (tol 1e-5), worst gradient rel L2 "
          f"{worst:.3e} over {len(gp)} tensors (tol 1e-4); launches K2 {launched[1]} "
          f"K2-residual {launched[3]} K4 {launched[4]} K5 {launched[5]} at head widths "
          f"{widths}", flush=True)
    want_widths = [8] if recon is None else [8, 512]
    if gc.keys() != gp.keys() or any(w != want_widths for w in widths):
        fail(f"the tiny {what} did not reach the flash kernels at head widths "
             f"{want_widths} or lost gradients")
    if not (rel_loss <= 1e-5 and rel_metrics <= 1e-5 and worst <= 1e-4):
        fail(f"the card's tiny {what} disagrees with the CPU port")


# ------------------------------------------------------------------ phase 8

FULL_STEPS = 2
# Phase 8: the split_grad=2 step against the monolith on the same weights,
# batch and draws, bf16 on the card. Both run the same deterministic kernels
# on the same values; the gradients are summed into .grad in another order
# (the recon portion's, then the eps portion's), and cuDNN's and cuBLAS's
# backward kernels may sum in an order that changes from run to run. Seen on
# the H100: the same loss to the last digit, gradient 3.3e-4 relative L2 over
# all trainable tensors; the limit is 3x that, and far below the 1.9e-3 by
# which flash and einsum attention differ in phase 7.
SPLIT_TOL = {"loss": 1e-5, "grad": 1e-3}


def full_loss_plan(recon, batch: int) -> dict:
    """Launches per full-loss step, by wrapper and (BH,N,M,D), worked out
    from the configuration. The UNet runs 1 + ddim_steps passes under
    autograd, each with 5 flash self-attentions at 4096 tokens (d=40) and 5
    at 1024 (d=80), whose forward runs twice under block remat. Three latents
    are collected and decoded: the noisy input, which depends on no parameter
    (one forward, no backward), and the first and last pred_x0 (under the
    towers' checkpoint: forward twice, K4 and K5 once). The two VAE encodes
    run without gradients through K2. No K1, no K3. The plan counts wrapper
    calls: bf16 K5 at d=512 is one flash_bwd_dq call of two launches (dS,
    then dQ = dS K)."""
    passes = 1 + recon.ddim_steps
    unet = {(8 * batch, 4096, 4096, 40): 5, (8 * batch, 1024, 1024, 80): 5}
    wide = (batch, 4096, 4096, 512)
    n_dec, n_grad = 3, 2
    return {
        "self_attention_smalld": {},
        "wide_attention": {wide: 2},
        "group_norm_silu": {},
        "flash_attention_fwd": {**{k: 2 * c * passes for k, c in unet.items()},
                                wide: n_dec + n_grad},
        "flash_bwd_dkv": {**{k: c * passes for k, c in unet.items()}, wide: n_grad},
        "flash_bwd_dq": {**{k: c * passes for k, c in unet.items()}, wide: n_grad},
    }


def decode_under_autograd(modules):
    """The VAE built for training decodes a latent that requires grad: the
    forward launches FlashAttention's forward at d=512 and never K2 (which
    has no backward), the backward K4 and K5 once each."""
    g = torch.Generator(device="cuda").manual_seed(8)
    z = torch.randn((1, 4, 64, 64), generator=g, device="cuda").requires_grad_()
    before = counts()
    img = modules.decode_latent(z)
    fwd = tuple(x - y for x, y in zip(counts(), before))
    img.square().mean().backward()
    torch.cuda.synchronize()
    both = tuple(x - y for x, y in zip(counts(), before))
    ok = bool(torch.isfinite(z.grad).all()) and bool(z.grad.any())
    print(f"  one decode under autograd (VAE remat {modules.vae.config.remat}): launches "
          f"(K1, K2, K3, K2-residual, K4, K5) forward {fwd}, with the backward {both}; "
          f"latent gradient finite and non-zero {ok}", flush=True)
    if fwd != (0, 0, 0, 1, 0, 0) or both != (0, 0, 0, 1, 1, 1) or not ok:
        fail("the decode under autograd did not run FlashAttention (forward, K4, K5) "
             "at d=512, or launched K2")


def all_grads(modules):
    return {k: p.grad.float().clone() for k, p in named_params(modules).items()
            if p.grad is not None}


def full_loss_path():
    """The full-loss step at full width (phase 8). Returns (launches of the
    main path in KERNELS order, launches by wrapper and shape per step and
    over the run, step times, peak memory, batch)."""
    cfg = SwapConfig()
    recon = ReconLossConfig()
    tcfg = TrainConfig(warmup_steps=1)  # as phase 7: every trainable moves
    train_step, _, init_state = make_train_step(cfg, tcfg, recon=recon, device="cuda")
    split_step, _, _ = make_train_step(cfg, dataclasses.replace(tcfg, split_grad=2),
                                       recon=recon, device="cuda")
    t0 = time.perf_counter()
    state = init_state(seed=0)
    for i, m in enumerate(state.modules.towers().values()):
        init_params(m, seed=i, dezero=True)  # gradients reach every layer
    named = named_params(state.modules)
    labels = trainable_labels(named)
    n_train = sum(p.numel() for k, p in named.items() if labels[k] == "train")
    torch.cuda.synchronize()
    print(f"  built the training towers {sorted(state.modules.towers())} in "
          f"{time.perf_counter() - t0:.1f} s: {n_train:,} trainable parameters (fp32), "
          f"UNet remat {state.modules.unet.config.remat}, VAE remat "
          f"{state.modules.vae.config.remat}, recon {recon}", flush=True)
    decode_under_autograd(state.modules)

    hw = cfg.latent_size
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(batch):
        batches = [make_request(300 + i, cfg.image_size, "cuda", batch=batch)
                   for i in range(FULL_STEPS)]
        draws = [make_draws(batch, hw, tcfg, "cuda", gen) for _ in range(FULL_STEPS)]
        draws[0]["drop"][0] = True  # the null token gets a gradient
        return batches, draws

    # batch 4 if one forward and backward fits the card, else batch 2
    batch = TRAIN_BATCH
    batches, draws = inputs(batch)
    torch.cuda.reset_peak_memory_stats()
    reason = None
    try:
        train_step.loss_and_grads(state.modules, batches[0], draws[0])
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        reason = str(e).splitlines()[0]
    if reason is not None:  # outside the handler, which holds the step's tensors
        print(f"  batch {batch} does not fit the card ({reason}): running batch "
              f"{batch // 2}", flush=True)
        for p in named.values():
            p.grad = None
        batch //= 2
        del batches, draws
        torch.cuda.empty_cache()
        batches, draws = inputs(batch)
        torch.cuda.reset_peak_memory_stats()
        train_step.loss_and_grads(state.modules, batches[0], draws[0])
        torch.cuda.synchronize()
    print(f"  batch {batch}: one forward and backward fits (this one also warms up), "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB before the "
          f"optimizer's first step", flush=True)
    plan = full_loss_plan(recon, batch)
    snapshot = {k: p.detach().clone() for k, p in named.items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the full-loss path's run starts here
    times, per_step = [], None
    run_shapes = {kern.__name__: collections.Counter() for kern in KERNELS}
    for s in range(FULL_STEPS):
        before = counts()
        for kern in KERNELS:
            kern.shapes = collections.Counter()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, metrics = train_step(state, batches[s], draws[s])
        b.record()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_step = {kern.__name__: dict(kern.shapes) for kern in KERNELS}
        for kern in KERNELS:
            run_shapes[kern.__name__] += kern.shapes
            kern.shapes = None
        times.append(wall)
        d = tuple(x - y for x, y in zip(counts(), before))
        vals = {k: metrics[k].item() for k in ("loss", "loss_simple", "id_loss", "lpips_loss")}
        print(f"  step {s}: " + ", ".join(f"{k} {v:.5f}" for k, v in vals.items())
              + f"; {wall:.3f} s (host enqueue {host:.1f} ms, device {a.elapsed_time(b):.1f} "
              f"ms), launches K1 +{d[0]} K2 +{d[1]} K3 +{d[2]} K2-residual +{d[3]} K4 "
              f"+{d[4]} K5 +{d[5]}", flush=True)
        if not all(map(math.isfinite, vals.values())):
            fail(f"step {s}: a metric is not finite: {vals}")
        if per_step != plan:
            fail(f"step {s}: launches by shape {per_step}, planned {plan}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    print("  launches per step by (BH,N,M,D), equal to the plan worked out from the "
          "configuration: " + "; ".join(f"{k} {v}" for k, v in per_step.items() if v),
          flush=True)
    moved = [k for k, p in named.items() if not torch.equal(p, snapshot[k])]
    stuck = [k for k in moved if labels[k] == "freeze"] + [
        k for k in named if labels[k] == "train" and k not in moved]
    frozen_towers = sorted({k.split(".")[0] for k, v in labels.items() if v == "freeze"})
    print(f"  after {FULL_STEPS} steps: {sum(labels[k] == 'train' for k in moved)} of "
          f"{sum(v == 'train' for v in labels.values())} trainable tensors moved, "
          f"{sum(labels[k] == 'freeze' for k in moved)} of "
          f"{sum(v == 'freeze' for v in labels.values())} frozen ones did (frozen "
          f"tensors in {frozen_towers})", flush=True)
    if stuck or frozen_towers != ["conditioner", "lpips", "vae"]:
        fail(f"trainable tensors that did not move or frozen ones that did: {stuck[:8]}")
    del snapshot
    steady = times[1:]
    mean = sum(steady) / len(steady)
    print(f"  step time first {times[0]:.3f} s, steady {mean:.3f} s, {batch / mean:.3f} "
          f"samples/s; peak memory {peak / 2**30:.2f} GiB", flush=True)
    profile_forward(lambda: train_step(state, batches[0], draws[0]),
                    what="full-loss training step", grad=True, top=12)

    # split_grad=2 on the same weights, batch and draws as the monolith
    loss_m, _ = train_step.loss_and_grads(state.modules, batches[0], draws[0])
    g_m = all_grads(state.modules)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss_s, metrics_s = split_step.loss_and_grads(state.modules, batches[0], draws[0])
    g_s = all_grads(state.modules)
    torch.cuda.synchronize()
    split_peak = torch.cuda.max_memory_allocated()
    rel_loss = abs(loss_s.item() - loss_m.item()) / abs(loss_m.item())
    rel_grad = rel_l2(g_s, g_m)
    print(f"  split_grad=2 against the monolith, one step (bf16): loss {loss_s.item():.6f} "
          f"vs {loss_m.item():.6f} (rel {rel_loss:.3e}, tol {SPLIT_TOL['loss']:.0e}), "
          f"gradient rel L2 {rel_grad:.3e} over {len(g_m)} tensors (tol "
          f"{SPLIT_TOL['grad']:.0e}); peak memory of the split step "
          f"{split_peak / 2**30:.2f} GiB, the monolith's gradients held beside it", flush=True)
    if g_s.keys() != g_m.keys() or sorted(metrics_s) != sorted(metrics) \
            or not (rel_loss <= SPLIT_TOL["loss"] and rel_grad <= SPLIT_TOL["grad"]):
        fail("the split_grad=2 step disagrees with the monolith")
    del state, g_m, g_s
    torch.cuda.empty_cache()
    return launches, per_step, run_shapes, times, peak, batch


# ------------------------------------------------------------------ main

def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("phase 1: device, kernel build, towers and the survey of kernel shapes", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    t0 = time.perf_counter()
    reports = kernels.build()
    for name in kernels.SOURCES:
        kernels.library(name)
    inst = {n: ptxas_instances(r) for n, r in reports.items()}
    regs = {n: sorted({r for r, _ in v.values()}) for n, v in inst.items()}
    spills = {n: [b for _, b in v.values() if b] for n, v in inst.items()}
    print(f"  built {len(reports)} kernel libraries in {time.perf_counter() - t0:.1f} s "
          f"(registers per thread {regs}; spill-store bytes of the instances that spill "
          f"{spills})", flush=True)
    hopper = {f"{short_name(k)} ({lib})": v for lib, by in inst.items()
              for k, v in by.items() if "_sm90" in k}
    print("  ptxas, the Hopper instances (registers, spill-store bytes): "
          + "; ".join(f"{k} {v}" for k, v in sorted(hopper.items())), flush=True)
    if any(b for k, (_, b) in hopper.items() if "attn_fwd_sm90<512" not in k):
        fail("a Hopper kernel instance below D = 512 spills")
    for name, secs in kernels.BUILD_SECONDS.items():
        print(f"  nvcc {name}: {secs:.1f} s", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"  ptxas {name}: {line.strip()[:200]}", flush=True)
    check_sass()

    cfg = SwapConfig()
    swapper = build_swapper(cfg)
    k1_shapes, k2_shapes, k3_shapes = survey(swapper, cfg)
    k1_per_fwd, k2_per_swap, k3_per_fwd = PLANNED.values()
    print(f"  main-path shapes as the wrappers recorded them: K1 per UNet forward "
          f"{dict(k1_shapes)}, K2 per swap {dict(k2_shapes)}, K3 per fused forward "
          f"{k3_per_fwd} calls over {len(k3_shapes)} shapes (the planned counts)", flush=True)

    print("phase 2: kernels against their plain versions on the card", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    as4 = lambda c: collections.Counter({(bh, n, n, d): k for (bh, n, d), k in c.items()})
    entries = {
        "K1": check_attention("K1", self_attention_smalld, as4(k1_shapes),
                              [(16, 4096, 4096, 40), (16, 1024, 1024, 80), (3, 1000, 1000, 40),
                               (3, 200, 200, 80), (2, 1024, 1024, 8)] + K1_WIDE_SHAPES, gen),
        "K2": check_attention("K2", wide_attention, k2_shapes,
                              [(1, 4096, 4096, 512), (2, 1000, 1100, 512),
                               (2, 1000, 1100, 256), (8, 1000, 1100, 40),
                               (4, 1000, 1100, 80)], gen),
        "K3": check_groupnorm(k3_shapes, gen),
    }
    entries["K1"]["d160"] = time_k1_wide(gen)

    print(f"phase 3: the main path, SwapConfig() at {cfg.image_size} px, DDIM-"
          f"{cfg.ddim_steps}, CFG {cfg.cfg_scale}, dedup, {REQUESTS} requests of "
          f"batch {BATCH}", flush=True)
    main_launches, lat, peak = serve(swapper, cfg, k1_per_fwd, k2_per_swap)

    print(f"phase 4: bf16 towers against fp32 copies, UNet with and without "
          f"fused_groupnorm, batch {BATCH}", flush=True)
    k3_launches = towers_vs_fp32(swapper, cfg, k3_per_fwd)
    del swapper
    torch.cuda.empty_cache()

    print("phase 5: a small input against the CPU port", flush=True)
    tiny_reference()

    print("phase 6: the training kernels against their plain versions on the card",
          flush=True)
    train_worst = check_train_kernels(gen, TRAIN_SHAPES + RAGGED_SHAPES)
    train_stats = time_train_kernels(gen, TRAIN_SHAPES)
    print("  the same kernels at the VAE decoder's head width, d = 512 (the split-depth "
          "bf16 forward of attention_fwd_sm90.cuh, K4 of attention_flash_bwd_wide.cu, bf16 "
          "K5 of attention_bwd_wide_sm90.cuh), and at d = 256", flush=True)
    wide_worst = check_train_kernels(gen, WIDE_SHAPES)
    wide_stats = time_train_kernels(gen, WIDE_SHAPES[1:2])

    print(f"phase 7: the eps-MSE training step, SwapConfig() at {cfg.image_size} px, "
          f"batch {TRAIN_BATCH}, {TRAIN_STEPS} steps", flush=True)
    train_launches, train_shapes, step_times, train_peak = train_path()
    tiny_train_reference()

    print(f"phase 8: the full-loss training step (eps-MSE + DDIM reconstruction with ID "
          f"and LPIPS losses), SwapConfig() at {cfg.image_size} px, {FULL_STEPS} steps",
          flush=True)
    (full_launches, full_per_step, full_run_shapes, full_times, full_peak,
     full_batch) = full_loss_path()
    tiny_train_reference(ReconLossConfig())
    wide_shape = (full_batch, 4096, 4096, 512)
    if wide_shape not in wide_stats["K2r"]:
        for key, by_shape in time_train_kernels(gen, [wide_shape]).items():
            wide_stats[key].update(by_shape)

    meta = {
        "K1": ("self_attention_smalld", "reface_tpu_torch/csrc/attention_fwd_sm90.cuh",
               "reface_tpu/ops/attention_smalld.py:118", main_launches[0],
               f"one UNet forward with CFG dedup at batch {BATCH}: "
               + ", ".join(f"{k}x(BH,N,D)={s}" for s, k in k1_shapes.items())),
        "K2": ("wide_attention", "reface_tpu_torch/csrc/attention_fwd_sm90.cuh",
               "reface_tpu/ops/attention.py:71", main_launches[1],
               "one swap (VAE encode + decode): "
               + ", ".join(f"{k}x(BH,N,M,D)={s}" for s, k in k2_shapes.items())),
        "K3": ("group_norm_silu", "reface_tpu_torch/csrc/groupnorm.cu",
               "reface_tpu/ops/groupnorm.py:80", k3_launches,
               f"one fused UNet forward at batch {BATCH}: {k3_per_fwd} calls over "
               f"{len(k3_shapes)} shapes"),
    }
    rows = []
    for key, (name, src, repl, launches, work) in meta.items():
        e = entries[key]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                     "launches": launches, "max_abs_err": e["max_abs_err"],
                     "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                     "bound_by": e["bound_by"], "library_ms": e["library_ms"],
                     "tol": e["tol"], "max_abs_err_fp32": e["max_abs_err_fp32"],
                     "rel_l2_err": e["rel_l2_err"], "work": work})
    rows[0]["also_replaces"] = "reface_tpu/ops/attention_smalld.py:141"
    rows[0]["max_abs_err_vs_smalld_attention_plain"] = entries["K1"][
        "max_abs_err_vs_smalld_attention_plain"]
    rows[0]["d160"] = entries["K1"]["d160"]
    lib_src = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    train_meta = {
        "K2r": ("flash_attention_fwd", "reface_tpu_torch/csrc/attention_fwd_sm90.cuh",
                f"{lib_src}:758", 3, "scaled_dot_product_attention forward"),
        "K4": ("flash_bwd_dkv", "reface_tpu_torch/csrc/attention_bwd_sm90.cuh",
               f"{lib_src}:1121", 4, "scaled_dot_product_attention backward alone (dq, dk, "
               "dv from a kept forward)"),
        "K5": ("flash_bwd_dq", "reface_tpu_torch/csrc/attention_bwd_sm90.cuh",
               f"{lib_src}:1456", 5, "scaled_dot_product_attention backward alone (dq, dk, "
               "dv from a kept forward)"),
    }
    # K4 and K5 also carry the library backward's device time and the library's
    # forward+backward time (PRs 2-4's yardstick)
    fwd_bwd = lambda t: {k: t[k] for k in ("library_device_ms", "library_fwd_bwd_ms") if k in t}
    for key, (name, src, repl, idx, lib_what) in train_meta.items():
        per_step = train_shapes[name]
        total = collections.Counter()
        for shape, count in per_step.items():
            for k2, val in train_stats[key][shape].items():
                total[k2] += count * val
        _, by = bound_ms(total["bytes"], total["ops"], "bf16", total["exps"])
        w = train_worst[key]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": f"{repl} (reached from reface_tpu/ops/attention.py:71)",
                     "launches": train_launches[idx], "max_abs_err": w["bf16"],
                     "ms": total["ms"], "plain_ms": total["plain_ms"],
                     "bound_ms": total["bound_ms"], "bound_by": by,
                     "library_ms": total["library_ms"], "library": lib_what,
                     "tol": TOL[key]["bf16"], "max_abs_err_fp32": w["fp32"],
                     "rel_l2_err": w["rel"], **fwd_bwd(total),
                     "work": f"one training step at batch {TRAIN_BATCH}: "
                             + ", ".join(f"{c}x(BH,N,M,D)={s}" for s, c in per_step.items())})
    # the same three kernels at d = 512, on the full-loss path (phase 8)
    for key, (name, _, repl, idx, lib_what) in train_meta.items():
        src = {"K2r": "reface_tpu_torch/csrc/attention_fwd_sm90.cuh",
               "K4": "reface_tpu_torch/csrc/attention_flash_bwd_wide.cu",
               "K5": "reface_tpu_torch/csrc/attention_bwd_wide_sm90.cuh"}[key]
        per_step = {sh: c for sh, c in full_per_step[name].items() if sh[3] == 512}
        total = collections.Counter()
        for shape, count in per_step.items():
            for k2, val in wide_stats[key][shape].items():
                total[k2] += count * val
        _, by = bound_ms(total["bytes"], total["ops"], "bf16", total["exps"])
        w = wide_worst[key]
        rows.append({"name": f"{name}_d512", "route": "cuda", "source": src,
                     "replaces": f"{repl} (reached from reface_tpu/ops/attention.py:71 by "
                                 "reface_tpu/nn/vae.py:98)",
                     "launches": sum(c for sh, c in full_run_shapes[name].items()
                                     if sh[3] == 512),
                     "max_abs_err": w["bf16"], "ms": total["ms"],
                     "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
                     "bound_by": by, "library_ms": total["library_ms"],
                     "library": lib_what, "tol": TOL[key]["bf16"],
                     "max_abs_err_fp32": w["fp32"], "rel_l2_err": w["rel"], **fwd_bwd(total),
                     "work": f"one full-loss step at batch {full_batch}: "
                             + ", ".join(f"{c}x(BH,N,M,D)={sh}" for sh, c in per_step.items())})
    for row, wide_row, idx in zip(rows[3:6], rows[6:9], (3, 4, 5)):  # K2r, K4, K5
        row["launches_full_loss_path"] = full_launches[idx] - wide_row["launches"]
    steady = lat[1:] or lat
    tsteady = step_times[1:]
    fsteady = full_times[1:]
    print(f"summary: {smi}; swap latency first {lat[0]:.3f} s, steady "
          f"{sum(steady) / len(steady):.3f} s, {BATCH * len(steady) / sum(steady):.3f} "
          f"swaps/s, peak {peak / 2**30:.2f} GiB; train step (batch {TRAIN_BATCH}) first "
          f"{step_times[0]:.3f} s, steady {sum(tsteady) / len(tsteady):.3f} s, peak "
          f"{train_peak / 2**30:.2f} GiB; full-loss step (batch {full_batch}) first "
          f"{full_times[0]:.3f} s, steady {sum(fsteady) / len(fsteady):.3f} s, peak "
          f"{full_peak / 2**30:.2f} GiB; wall {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
