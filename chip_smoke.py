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
     instance of the attention forward, K1's included at every width, of K4
     and K5 at D <= 128 and of the three d > 128 backward kernels must hold
     wgmma and TMA instructions, HGMMA and UTMALDG, and no bf16 mma.sync
     instance of the old kernels they replace may be left to reach; every
     K3 instance must wait at the cluster barrier, UCGABAR, the resident
     ones bring their slice in with the bulk copy, UBLKCP, and the two
     kernels of K3's first, two-launch design may not be left);
  2. kernels: K1 (UNet self-attention), K2 (VAE mid-block attention) and K3
     (GroupNorm+SiLU) against their plain PyTorch versions at every shape the
     survey found, K1 also at ragged and tiny shapes and at 128 < D <= 256
     (d = 160 timed beside sdpa), and one UNet forward at a 1024 px input's
     128 x 128 latent (K1 at d = 40, 80 and 160, held to a plan), and K2 at
     ragged shapes and D = 40, 80, 160, 256, in bf16 and fp32 (TF32 off); bf16 K1 also against
     the TPU kernel's own function (smalld_attention_plain, both modes, one
     bf16 ulp), bf16 K2 against the library's function
     (flash_attention_fwd_plain, one bf16 ulp) and bit-equal to the residual
     forward; K3 also at a tiny shape and at groups too large for a
     cluster's shared memory, into NaN-filled outputs, two calls bit-equal;
     K3 without the SiLU at the swap benchmark's shapes (batch 10), the
     VAE's 512 px levels on the streaming path included (bf16 held in ulps
     of each |y|), and GroupNorm32's unfused norm taking it without
     autograd (a channels-last input too) and the plain version under
     autograd;
     each timed with CUDA events beside its bound (bytes, tensor
     operations or exp2s), its plain version and one PyTorch library call,
     K3 also by the profiler's device time and the host's enqueue per call;
  3. the main path: 512 px, DDIM-50, CFG 3, CFG prefix dedup, 2 requests of
     batch 2 through FaceSwapper.swap; checks the output and the kernels'
     launch counts;
  4. bf16 against fp32: the UNet (unfused, and UNetConfig(fused_groupnorm=
     True) through K3), the VAE and the conditioner, each at full width
     against an fp32 copy with the same weights; the fused forward profiled,
     one K3 kernel a call;
  5. a small input against a reference: the 256 px tiny config in fp32 on the
     card (K1, K2 and K3 all launched) against the port on the CPU, where
     every kernel wrapper computes its plain version;
  9. (run after phase 5) the swap's other serving modes at SwapConfig()'s
     widths with phase 3's weights, batch 2, one warm-up and one timed
     request each through FaceSwapper.swap: PLMS-50; DPM-Solver++(2M)-20 on
     the lam_uniform grid, with and without cfg_steps=8; DDIM-50 with the
     int8 and the int8conv modes (UNet fused GroupNorm, VAE, CLIP int8);
     the distilled-student rung (DDIM-10, cfg 1.0, fast attention,
     int8conv); 1024 px with VAE and UNet tiles (DDIM-10, depth cut from
     50). Each output finite in [-1,1]; K1 and K2 launches by shape, K3
     and the int8 products by count, against the plan from the config; K1
     and K2 at the tiles' shapes against their plain versions; the card's
     int8 product (torch._int_mm) bit-equal to its plain version at each
     shape of an int8 UNet forward, the int8 UNet forwards against bf16;
     each mode at the tiny fp32 config on the card against the CPU port
     (int8 site by site); fold(unfold(x)) == x; per mode the latency,
     swaps/s, peak memory and launches, and per int8 shape class the
     _int_mm, int8-site and bf16 times; the 1024 px tiled VAE encode of an
     image whose centre 512 px tile is all zero, and that tile alone, bf16
     against fp32 (ROADMAP C2);
  10. (run after phase 9) the raw-image path, RawSwapPipeline with
     RawPipelineConfig() (1024 px align, 512 px BiSeNet, LandmarkNet at 256
     px, both bf16, seeded random weights) on phase 3's towers:
     swap_images on a batch of 2 1024 x 1024 frames and sources (one
     warm-up, one timed request, then the same request stage by stage by
     CUDA events: landmarks, align, source reference, parse, swap, paste
     back), swap_images_robust with both one_program values on two batches
     of 4 1080 x 1920 frames with a host landmark function that places a
     68-point face and a forced presence pattern (a pass-through frame, the
     carry inside a batch and across the two); each output the frame's
     shape, finite, in [0,1], every quad finite with area > 0, pass-through
     frames unchanged, K1 and K2 launches by shape and K3 by count against
     the plan of the swap at that batch; bf16 BiSeNet and LandmarkNet
     against fp32 copies; the tiny fp32 raw path on the card against the
     CPU port (every entry point, detect_faces' boxes equal);
  11. (run after phase 10) the user entry points on phase 3's towers at
     batch 1: the towers written as the reference's files (a REFace
     last.ckpt with LitEma's model_ema.* and the Lightning entries, the
     CLIP tower as an HF CLIP file, a face-parsing BiSeNet file, two
     diffusers safety checkers) under build/, their sizes and times, and
     read back by cli.common.build_swapper, every tensor bit-equal to phase
     3's after the bfloat16 cast; GEGLU with SD's erf gelu against the
     port's tanh (ROADMAP C1): one UNet forward in bf16 and in fp32 and one
     DDIM-50 request, relative L2 of eps and of the image; cli.swap --precropped on a PNG
     and a baseline-JPEG target written by the port's encoders, read back
     by its decoder, the PNG within one level of FaceSwapper.swap called
     directly; cli.swap raw on 1024 px JPEG targets with the BiSeNet file;
     the demo server (raw, a safety checker that flags nothing) answering
     three multipart POSTs of 1024 px JPEGs with PNGs, then a server whose
     checker flags everything answering the first upload with the blur of
     the unflagged response, and a server request's steps called one by one
     (decodes, the swap in the main thread and in fresh threads, the
     checker, the PNG encode); each driver's launches by shape against
     mode_plan(cfg, 50, batch=1); K1 and K2 at the batch-1 shapes against
     their plain versions; the host codecs' times at 1024 px; the files
     deleted at the end;
  12. (run after phase 11) the reference's test bench on phase 3's towers:
     a CelebA-style tree of 12 pairs (1024 px baseline JPEGs, 512 px
     19-class masks) and an FFHQ-style tree of 2 (512 px PNGs) written by
     the port's encoders, seeded eval towers written as the reference's
     files (an HF CLIP ViT-B/32 file, Hopenet with fc_finetune,
     Deep3DFaceRecon's net_recon.*, ArcFace) and the towers' state dicts;
     FaceSwapper.swap called directly on the driver's two batches (the
     tail of 2 padded to 10), then cli.inference_test_bench --n-samples 10
     --num-pairs 12 once to warm up and once timed: the 12 PNGs
     {sid}_{tid}.png, none for the padded rows, each within one level of
     the direct swap; the FFHQ tree at --n-samples 2; each run's K1 and K2
     launches by shape and K3's by count against mode_plan at its batch;
     cli.evaluate --metrics fid id pose expression on the results, the
     four metrics finite and no kernel launched, each metric's images/s;
     each eval tower read from its file on the card against the CPU port
     (fp32 ResNet-50s with TF32 off, bf16 CLIP and IR-SE-50, EVAL_TOL);
     K1 and K2 at the batch-10 shapes against their plain versions; the
     files deleted at the end;
  6. the training kernels against their plain versions at the shapes of the
     UNet's self-attention in training (batch 4: (BH,N,D) = (32,4096,40) and
     (32,1024,80), and ragged ones at d = 40 and 80), of the VAE decoder's
     mid-block ((1,4096,512), (4,4096,512), a ragged one, and a ragged
     d = 256 off the main path) and of a 1024 px UNet's d = 160 level in
     training ((32,1024,1024,160) and a ragged one, padded to 256 by the
     wrappers), bf16 and fp32: the forward with residuals (K2's o and lse),
     K4 (dk, dv) and K5 (dq; at d > 128 in bf16 also the dS and P
     workspaces that K5's call writes and K4's GEMM reads, against
     flash_bwd_ds_plain, zeros at keys past M included), each timed beside
     its bound, its plain version and scaled_dot_product_attention (for K4
     and K5 its backward alone, which computes dq, dk and dv together from a
     kept forward, and beside it the forward and backward);
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
     full-loss step on the card against the CPU port;
  13. (run after phase 8) the training entry point: cli.train at SwapConfig()
     widths and 512 px on a CelebA-style tree of 1024 px items (masks merged
     by cli.prepare_data merge-celeba-masks), run A: 4 full-loss steps at
     batch 4 with seeded LPIPS and LandmarkNet files, EMA, validation every 2
     steps with top-1 retention, a sample swap and checkpoints; the losses
     finite, every trainable tensor moved and no frozen one, each step's,
     validation batch's and sample swap's launches by shape against their
     plans, the files; its step time, the share of each step spent waiting
     on the loader, peak memory and each checkpoint's bytes and save
     seconds; run B resumes from step 2 (the loaded state bit-equal to the
     files) to step 4; one split_grad=2 step with the bf16 accumulator
     against the fp32 one (ACC_TOL); an eps-MSE run on an FFHQ-style tree;
     cli.swap --ckpt on run B's params file within one level of
     FaceSwapper.swap on the same weights; cli.prepare_data
     expand-sd-checkpoint, estimate-ffhq-masks and crop-and-mask; K2 at the
     trainer's batch-4 shape. At most two full checkpoints (~12 GiB each)
     are on disk at once, and every file is deleted at the end;
  14. (run after phase 12) the gradient-guided swap and the priors on phase
     3's towers: FaceSwapper.swap_guided at batch 2, DDIM-50, CFG 3 with the
     ID term (one warm-up, then one request twice with the same seed, the
     two bit-equal; the gradient at the 24 steps with 5 < t < 500), its
     launches by wrapper and shape against the plan
     from the config (K2r, K4 and K5 at (2,4096,4096,512) once a gated
     step, K2 only for the encode and the final decode); one guided step by
     CUDA events (the CFG eps, the guidance gradient, the decode's forward
     and backward); guidance scale 0 against FaceSwapper.swap; one step's
     ID loss and latent gradient against attn_impl="einsum" (phase 7's
     limits); a request with id, seg and exp (fp32 BiSeNet and D3DFR files
     written as the reference's; one decode a step at all 50 steps) twice
     with the same seed, bit-equal; per term, one guided step's gradient
     under torch.use_deterministic_algorithms(True, warn_only=True) (what it
     flags is printed) and three such gradients bit-equal; DIFT's
     index agreement between bf16 and fp32 features; the tiny fp32 guided
     swap on the card against the CPU port; cli.swap --guidance id,seg,exp
     --precropped and raw (DDIM-10), each run twice with the same seed, the
     two files bit-equal and within one level of its direct call;
     cli.prepare_data make-priors --method tps (a LandmarkNet file)
     and dift (the towers' params file) on a CelebA-style tree of 4 pairs
     at 512 px, each prior the target outside its mask, seconds a pair;
     cli.inference_test_bench --prior-dir on the DIFT priors within one
     level of FaceSwapper.swap(prior_image=...), K2 encoding the prior too;
     K2r, K4 and K5 at (2,4096,4096,512) against their plain versions,
     timed beside their bounds and sdpa. The files are deleted at the end;
  15. (run after phase 14) the remaining trainers on phase 3's towers:
     cli.distill at SwapConfig() widths, 512 px, batch 4, round 0 of 50 ->
     10 (a 5-step teacher window under CFG 3, the teacher in bf16) from a
     --teacher-ckpt params file of the towers, on a CelebA-style tree of 8
     items, 3 steps: losses finite, every student tensor with a gradient
     moved (the 64 a one-token context leaves without one did not), the
     teacher and the frozen towers bit-identical, each step's launches by
     wrapper and shape against distill_step_plan, manifest.json; the
     teacher window's end, and one step's loss and student gradient with the
     student's attention, against einsum (phase 7's limits), the same step
     on fp32 copies of both UNets against einsum (ROADMAP C3), and the
     teacher window's share of a step by CUDA events; cli.swap
     --precropped --ckpt <out>/params.pt --ddim-steps 10 --scale 1.0 within
     one level of FaceSwapper.swap on the same weights; two tiny fp32
     rounds (50 -> [25, 5]) on the card against the CPU port.
     cli.train_vae at VAEConfig() widths, 256 px, batch 4, from phase 3's
     VAE in a REFace-layout file and a seeded LPIPS file, on 8 images (one
     .JPG), with the gate open (3 steps) and closed (2): losses and d_weight
     finite, d_weight 0 with the gate closed, the trees moved (the
     discriminator only with the gate open), each step's launches by shape
     (K2 once, K2r 3, K4 2, K5 2 at (4,1024,1024,512); no K2 under
     autograd); one generator step against einsum; a tiny fp32 step on the
     card against the CPU port (held to 3x the CPU port's own spread
     between one thread and all). cli.train_landmarks at
     LandmarkNetConfig(), 256 px, on 192 faces make_landmark_faces drew,
     300 steps: the L1 falls, the held-out error under the mean shape's,
     the file read back by build_raw_pipeline's --landmark-ckpt. K2 at
     (4,1024,1024,512), K2r, K4 and K5 there and at the teacher's
     (64,4096,4096,40) and (64,1024,1024,80) against their plain versions,
     timed beside their bounds and sdpa. The files are deleted at the end;
  16. (run after phase 15) the video driver on phase 3's towers:
     cli.video_swap with the RawPipelineConfig() pipeline (BiSeNet and
     LandmarkNet files) over a 24-frame 1080 x 1920 MJPEG AVI the port
     writes (faces drawn from the landmark template; 4 frames without one,
     read from the frames as phase 10 forces its pattern), in its batches of
     10 at its DDIM-30 default, the last batch of 4 padded; its PNG frames
     within one level of swap_images_robust called directly batch by batch
     with the same generator, inv_transforms.npy within 1e-3 px of the
     quads; frame 0 passed through, each frame without a face its last good
     frame's swap (its quad, its pixels outside the paste); swapped.avi of
     24 frames at 25 fps; K1 and K2 by shape against 3 x the batch-10 plan
     (31 UNet forwards a batch); the --bench-json frames/s, and again with
     --bench-ram (frames decoded before the clock, no writer), peak
     memory, and whether the host has
     ffmpeg (if it has, swapped.mp4 is written). The files are deleted at
     the end;
  17. (run after phase 13) the parallel runtime (parallel/mesh.py,
     parallel/tp.py) on the one card. (a) In a process of its own: two
     eps-MSE steps at SwapConfig() widths, 512 px, batch 4, plain and with
     the mesh of a world of one over NCCL (init_distributed with
     --coordinator 127.0.0.1:<free port>), and cli.train for 2 steps at
     batch 2 on a 4-item CelebA-style tree without the flags and with
     --coordinator/--num-processes 1/--process-id 0, all under
     cudnn.deterministic: losses, UNet gradient, updated UNet and the
     driver's losses bit-equal. (b) Two processes sharing cuda:0 over gloo
     (NCCL refuses two ranks on one device): a DP step (2 rows a rank)
     bit-equal to the mean of the one-process step's two halves and within
     phase 7's limits of (a)'s batch-4 step (loss, UNet gradient, the
     clip's global norm and the UNet's change by AdamW, every step at lr
     100 behind a clip of 1e-9: PAR_TCFG); a TP UNet forward (bf16, batch
     2, CFG dedup) within phase 4's bf16 limit of the whole UNet, in fp32
     within TP_FP32_TOL, K1 per rank by shape against mode_plan with the
     heads halved; a TP step (the 4 rows on both, half the heads and
     channels a rank) within phase 7's limits of (a)'s step, the same four
     held, the norm over the model group and the change gathered. Each step's seconds and those in
     collectives are printed as two ranks sharing one card, not a scaling
     figure. K1, K2r, K4 and K5 at the per-rank TP shapes against their
     plain versions, timed. The files are deleted at the end.

It prints one JSON line of kernel numbers and, last, {"ok": true, "device":
...}. Any failure exits non-zero before that line; without a CUDA device it
exits non-zero at once.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import math
import re
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from reface_tpu_torch.ckpt import io as ckpt_io
from reface_tpu_torch.ckpt.from_torch import UNET_PREFIX, VAE_PREFIX, save_swap_params
from reface_tpu_torch.cli import common as cli_common
from reface_tpu_torch.cli import demo_server
from reface_tpu_torch.cli import distill as cli_distill
from reface_tpu_torch.cli import evaluate as cli_evaluate
from reface_tpu_torch.cli import inference_test_bench as cli_test_bench
from reface_tpu_torch.cli import prepare_data as cli_prepare
from reface_tpu_torch.cli import swap as cli_swap
from reface_tpu_torch.cli import train as cli_train
from reface_tpu_torch.core.schedules import DDIMTables, DiffusionSchedule
from reface_tpu_torch.data import (
    CelebAHQConfig,
    CelebAHQDataset,
    TestBenchConfig,
    TestBenchDataset,
    collate,
    make_synthetic_celeba,
    make_synthetic_ffhq,
)
from reface_tpu_torch.eval import CLIP_B32, FaceReconCoeffNet, Hopenet
from reface_tpu_torch.eval import expression_coeffs, pose_angles, protocol as eval_protocol
from reface_tpu_torch.eval.fid import clip_features
from reface_tpu_torch.io import images
from reface_tpu_torch.nn.arcface import CLIP_MEAN, CLIP_STD, IRSE50, ArcFaceConfig
from reface_tpu_torch.nn.clip import CLIPVisionTower
from reface_tpu_torch.nn.bisenet import BiSeNet, BiSeNetConfig, parse_faces
from reface_tpu_torch.nn.conditioner import REFaceConditioner
from reface_tpu_torch.nn.landmarks import LandmarkNet, LandmarkNetConfig
from reface_tpu_torch.nn.lpips import LPIPS
from reface_tpu_torch.nn.safety import SafetyChecker, SafetyCheckerConfig
from reface_tpu_torch.nn.unet import UNetConfig, UNetModel
from reface_tpu_torch.nn.vae import SD_SCALE_FACTOR, AutoencoderKL, VAEConfig
from reface_tpu_torch.nn.layers import CrossAttention, FeedForwardGEGLU, GroupNorm32
from reface_tpu_torch.ops import attention as PA
from reface_tpu_torch.ops import kernels
from reface_tpu_torch.ops.attention import wide_attention
from reface_tpu_torch.ops.attention_smalld import (
    einsum_attention,
    self_attention_smalld,
    smalld_attention_plain,
)
from reface_tpu_torch.ops.groupnorm import cluster_plan, group_norm_silu, group_norm_silu_plain
from reface_tpu_torch.ops import quant as PQ
from reface_tpu_torch.ops.resize import resize_bilinear_aa
from reface_tpu_torch.parallel import tiling
from reface_tpu_torch.pipelines.raw import RawPipelineConfig, RawSwapPipeline, tiny_raw_config
from reface_tpu_torch.pipelines.swap import (
    FaceSwapper,
    SwapConfig,
    clip_normalize,
    init_params,
    tiny_swap_config,
    un_norm,
)
from reface_tpu_torch.preprocess.align import paste_back
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
# K2: the VAE encoder's and decoder's mid-block; K3: every GroupNorm32 of a
# forward without autograd, fused or not: two norms in each of the 22
# ResBlocks, the output norm and the 16 SpatialTransformers' norms.
PLANNED = {"K1 per UNet forward": 10, "K2 per swap": 2, "K3 per UNet forward": 61}

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
# scores a plain attention computes at a time (by_heads)
PLAIN_HEADS_SCORES = 2**29
# bf16 K1 at 128 < D <= 256, one shape or more for each of its three Hopper
# instances (QK^T 160, 192 and 256 deep): off the 512 px main path, reached
# by a 1024 px input's 1024 tokens at d=160
K1_WIDE_SHAPES = [(16, 1024, 1024, 160), (3, 600, 600, 160), (2, 600, 600, 176),
                  (2, 1000, 1000, 256)]
# One UNet forward at a 1024 px input's 128 x 128 latent (batch 2, CFG
# dedup): K1 launches per forward by head width, 5 at each attention level
K1_PLAN_1024 = {40: 5, 80: 5, 160: 5}
# Relative L2 distance of each bf16 tower from an fp32 copy with the same
# weights (phase 4); random weights, full width. About twice what was seen:
# UNet 1.42e-2, fused 1.36e-2, VAE encode 1.57e-2, decode 1.17e-2,
# conditioner 7.2e-4 (its output is mostly the fp32 ID projection).
TOWER_TOL = {"UNet": 3e-2, "UNet fused": 3e-2, "VAE encode": 3e-2,
             "VAE decode": 3e-2, "conditioner": 2e-3}
# K3 with silu=False, as GroupNorm32's unfused norm takes it without
# autograd (ops/groupnorm.py::group_norm), at shapes of the swap benchmark's
# batch of 10: UNet norms of the CFG-deduplicated forward (10 and 20 rows)
# and the VAE decoder's 512 px levels, which take the streaming path.
K3_UNFUSED_SHAPES = ((10, 320, 64, 64), (20, 960, 64, 64), (20, 2560, 16, 16),
                     (10, 256, 512, 512), (10, 128, 512, 512))
# bf16 K3 there is held in bf16 ulps of each |y| (one ulp of 4 below |y| = 4:
# TOL's 2^-5), since outputs at those sizes reach |y| >= 8, where one ulp is
# 2^-4; and to REL_TOL_BF16
K3_ULPS, K3_ULP_FLOOR = 1, 4.0
# K3 beyond the fused UNet's shapes, in both dtypes: a tiny tensor (one CTA
# a group), and groups too large for a cluster's shared memory in fp32
# ((2,960,128,128): a fused UNet at 1024 px; in bf16 it stays resident, 8
# CTAs of 120 KB) and in both dtypes ((1,128,512,512): the VAE decoder's
# 512 x 512 level), which take the streaming path. (2,1280,8,8) (one CTA)
# and (2,960,64,64) (a full cluster of 8) are among the fused UNet's.
K3_EXTRA_SHAPES = ((1, 32, 8, 8), (2, 960, 128, 128), (1, 128, 512, 512))
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
KERNELS = (self_attention_smalld, wide_attention, group_norm_silu,
           PA.flash_attention_fwd, PA.flash_bwd_dkv, PA.flash_bwd_dq)

# Phase 9: the card's int8 product, restored after the check that swaps in
# int_mm_plain. The full-width int8 UNet forward against the bf16 one with
# the same weights, relative L2 (the JAX package holds one block to 5%
# max-relative): seen 4.83e-2 (int8) and 4.73e-2 (int8conv) on the H100,
# random weights; the limits are about twice that.
KERNEL_INT_MM = PQ.int_mm
INT8_TOL = {"int8": 0.1, "int8conv": 0.1}

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
# A 1024 px UNet's d=160 level in training (1024 tokens, 8 heads at batch
# 4) and a ragged shape: the wrappers pad the head to 256, as the JAX
# package's _flash_attention does
D160_SHAPES = ((8 * TRAIN_BATCH, 1024, 1024, 160), (4, 1000, 1100, 160))
# Ragged shapes (N, M not multiples of any tile) at the UNet's head widths,
# checked beside TRAIN_SHAPES in phase 6; (2, 1000, 1100, 256) above is a
# width off the main path.
RAGGED_SHAPES = ((32, 1000, 1100, 40), (4, 1000, 1100, 80))


def fwd_key_tile(d: int) -> int:
    """Keys per tile of the bf16 forward (csrc/attention_fwd_sm90.cuh:
    kBN = 128 at D <= 128, 32 above, at the padded width too): the
    dropped-tile checks drop these."""
    return 128 if d <= 128 else 32

# Launches per training step, in KERNELS order: under remat the forward of
# each of the 10 flash self-attentions runs twice; K4 and K5 once each in
# the backward; K2 once per VAE encode (target and masked target), which
# runs without autograd, and K3 once per GroupNorm32 of each encode (22);
# no K1; the UNet's norms run under autograd, on the plain version.
TRAIN_PLAN = (0, 2, 44, 20, 10, 10)
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


def device_ms_each(fns: dict, calls: int = 5) -> dict:
    """device_ms of each of several functions from one profiler session (a
    session for each would make dozens): each runs `calls` times inside a
    record_function scope of its own name, ending in a synchronise. The
    profiler marks each scope on the device's timeline too; a function's
    time is the summed durations of the kernels inside its mark, per call
    (the mark's own length would count the gaps between kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in fns.items():
            with record_function(name):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = {e.name: e.time_range for e in on_device if e.name in fns}
    kernels_ = [e.time_range for e in on_device if e.name not in fns]
    out = {name: sum(k.elapsed_us() for k in kernels_ if name in marks
                     and marks[name].start <= k.start and k.end <= marks[name].end)
           / 1e3 / calls for name in fns}
    if not all(out.values()):
        fail(f"the profiler saw no kernel in {[n for n, v in out.items() if not v]}")
    return out


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
    args = re.findall(r"L[ib](\d+)E", m.group(2) + "E")
    if "nv_bfloat16" in m.group(2) or m.group(2).startswith("f"):  # a type first (K3)
        args.insert(0, "bf16" if "nv_bfloat16" in m.group(2) else "fp32")
    return f"{m.group(1)}<{','.join(args)}>"


def sass_functions(name: str) -> dict:
    """{kernel's mangled name: its SASS} from cuobjdump -sass of the built
    library of csrc/<name>.cu."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = str(kernels.library_path(name))
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    return {f.splitlines()[0].strip(): f for f in sass.split("Function : ")[1:]}


# check_sass(): the Hopper kernels each library must hold, and the old
# kernels of which no bf16 (mma.sync) instance may be left
SASS_HOPPER = {
    "attention_wide": ("attn_fwd_sm90",),
    "attention_smalld": ("attn_fwd_sm90",),
    "attention_flash_bwd": ("flash_bwd_dkv_sm90", "flash_bwd_dq_sm90"),
    "attention_flash_bwd_wide": ("flash_bwd_ds_sm90", "flash_bwd_dq_gemm_sm90",
                                 "flash_bwd_dkv_gemm_sm90"),
}
SASS_OLD_BF16 = {
    "attention_wide": ("attn_fwd_kernel",),
    "attention_smalld": ("attn_fwd_kernel",),
    "attention_flash_bwd": ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"),
    "attention_flash_bwd_wide": ("flash_bwd_dq_wide_kernel", "flash_bwd_dkv_wide_kernel"),
}


# K3's instructions, as cuobjdump names them: every instance waits at the
# cluster barrier; the resident ones (template argument 1) bring their slice
# in with the bulk copy. The two kernels of K3's first design may not be left.
SASS_K3 = {"cluster barrier": "UCGABAR", "bulk copy": "UBLKCP"}
SASS_K3_OLD = ("gn_partial", "gn_apply")


def check_sass():
    """The Hopper kernels' instructions. Every bf16 instance of the attention
    forward (attn_fwd_sm90: K2 and K2r in attention_wide, K1 at every width
    in attention_smalld, with K1's rules), of K4 and K5 at D <= 128
    (flash_bwd_dkv_sm90, flash_bwd_dq_sm90 in attention_flash_bwd) and of
    the three d > 128 backward kernels (flash_bwd_ds_sm90,
    flash_bwd_dq_gemm_sm90, flash_bwd_dkv_gemm_sm90 in
    attention_flash_bwd_wide) runs wgmma (HGMMA) and TMA loads (UTMALDG);
    no bf16 instance of the old mma.sync kernels (HMMA) is left for them to
    reach (SASS_OLD_BF16). K3's instances hold SASS_K3, and SASS_K3_OLD are
    gone."""
    for lib, hopper in SASS_HOPPER.items():
        funcs = sass_functions(lib)
        for new_name in hopper:
            new = {n: (f.count("HGMMA"), f.count("UTMALDG")) for n, f in funcs.items()
                   if new_name in n}
            print(f"  SASS of {lib}: {len(new)} {new_name} instances, HGMMA / UTMALDG "
                  f"counts {sorted(new.values())}", flush=True)
            if not new or any(h == 0 or t == 0 for h, t in new.values()):
                fail(f"{lib}: a bf16 Hopper kernel {new_name} does not run wgmma and TMA")
            if lib == "attention_smalld" and any(not short_name(n).endswith(",1>") for n in new):
                fail("attention_smalld holds a Hopper forward without K1's rules")
        for old_name in SASS_OLD_BF16[lib]:
            old_bf16 = [n for n, f in funcs.items() if old_name in n and "HMMA" in f]
            print(f"  SASS of {lib}: bf16 mma.sync instances of {old_name}: "
                  f"{len(old_bf16)} (allowed 0)", flush=True)
            if old_bf16:
                fail(f"{lib}: the old bf16 kernel {old_name} is still there to reach")
    funcs = sass_functions("groupnorm")
    k3 = {short_name(n): {what: f.count(op) for what, op in SASS_K3.items()}
          for n, f in funcs.items() if "group_norm_sm90" in n}
    print(f"  SASS of groupnorm: {len(k3)} group_norm_sm90 instances, counts of "
          f"{SASS_K3}: {k3}", flush=True)
    if len(k3) != 4 or any(not c["cluster barrier"] or (k.endswith(",1>") and not c["bulk copy"])
                           for k, c in k3.items()):
        fail("groupnorm: a K3 instance lacks the cluster barrier or, resident, the bulk copy")
    if any(old in n for n in funcs for old in SASS_K3_OLD):
        fail("groupnorm: a kernel of K3's two-launch design is still there")


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
    in one UNet forward at batch 2 of a fused copy with the same weights
    (its SpatialTransformers' norms unfused). Each total is held to
    PLANNED."""
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


def ulps_off_bf16(out, ref, floor: float) -> float:
    """The largest |out - ref| in bf16 ulps of each |ref| (8 significant
    bits), the ulp taken at no less than `floor`."""
    ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(floor))) - 7)
    return float(((out.float() - ref.float()).abs() / ulp).max())


def ulp_bf16(ref) -> float:
    """One bf16 ulp (8 significant bits) at the largest magnitude of ref."""
    return 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)


def by_heads(fn, q, k, v, *args):
    """fn(q, k, v, *args) of a plain attention over (BH, N, D) operands,
    PLAIN_HEADS_SCORES scores (2 GiB in fp32) at a time: the heads are
    independent, and a tiled UNet's (288, 4096, 4096) scores would not fit
    the card at once."""
    step = max(1, PLAIN_HEADS_SCORES // (q.shape[1] * k.shape[1]))
    if step >= q.shape[0]:
        return fn(q, k, v, *args)
    return torch.cat([fn(q[i: i + step], k[i: i + step], v[i: i + step], *args)
                      for i in range(0, q.shape[0], step)])


def check_k2_function(q, k, v, scale, out):
    """bf16 K2 against the library's function: flash_attention_fwd_plain's o
    within K2_ULPS bf16 ulps of the largest |o|, and bit-equal to the
    residual forward's o (one kernel serves both entry points)."""
    ref = by_heads(lambda *a: PA.flash_attention_fwd_plain(*a)[0], q, k, v, scale)
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
    ref = by_heads(smalld_attention_plain, q, k, v, scale, fast)
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
            ref = by_heads(einsum_attention, q, k, v, scale)
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
                dropped = by_heads(einsum_attention, q, k[:, :-tile], v[:, :-tile], scale)
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
        plain = time_ms(lambda: by_heads(einsum_attention, q, k, v, scale))
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
    """bf16 K1 at d = 160 (the Hopper forward's kDp = 192 instance with K1's
    rules), off the 512 px main path: its time beside its bound,
    smalld_attention_plain and sdpa at K1_WIDE_SHAPES[0]."""
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


def unet_forward_1024(swapper, cfg: SwapConfig):
    """One UNet forward at a 1024 px input's 128 x 128 latent (the same
    UNet, batch 2, bf16, CFG dedup): K1's launches by head width against
    K1_PLAN_1024 (d = 160 at 1024 tokens reaches the wide instance), and a
    finite eps for both CFG halves. Einsum at 16384 tokens is too large
    to serve as its yardstick; K1_WIDE_SHAPES hold the kernel. Returns the
    launches by shape."""
    big = dataclasses.replace(cfg, image_size=1024, latent_size=128)
    x9, t, ctx2 = unet_inputs(big, seed=13, ctx_batch=2 * BATCH)
    self_attention_smalld.shapes = collections.Counter()
    with torch.inference_mode():
        out = swapper.unet(x9, t, ctx2, cfg_expand=True)
    torch.cuda.synchronize()
    shapes, self_attention_smalld.shapes = self_attention_smalld.shapes, None
    by_d = collections.Counter()
    for (_, _, d), c in shapes.items():
        by_d[d] += c
    ok = out.shape == (2 * BATCH, 4, 128, 128) and bool(torch.isfinite(out).all())
    print(f"  UNet forward at a 128 x 128 latent (1024 px, batch {BATCH}, dedup): K1 "
          f"launches {dict(shapes)}, by head width {dict(by_d)} (planned {K1_PLAN_1024}); "
          f"out {tuple(out.shape)} finite {ok}", flush=True)
    if dict(by_d) != K1_PLAN_1024 or not ok:
        fail("the 1024 px UNet forward did not launch K1 as planned or is not finite")
    return dict(shapes)


def host_us(fn, calls: int = 300) -> float:
    """The host's time to enqueue one call of fn(), in microseconds: `calls`
    calls back to back without a synchronise, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


@contextlib.contextmanager
def nan_filled_outputs():
    """Inside, torch.empty_like (where a kernel wrapper allocates its output)
    fills with NaN: an output element the kernel never writes then shows."""
    empty_like = torch.empty_like
    torch.empty_like = functools.partial(torch.full_like, fill_value=float("nan"))
    try:
        yield
    finally:
        torch.empty_like = empty_like


def group_norm_silu_library(x, scale, bias):
    """K3's function in PyTorch's library calls (the yardstick; bf16 affine)."""
    return F.silu(F.group_norm(x, 32, scale, bias, 1e-5))


def check_groupnorm(shapes, gen):
    """K3 against group_norm_silu_plain at each (B,C,H,W) of the fused UNet
    forward and at K3_EXTRA_SHAPES, fp32 and bf16, eps 1e-5 with SiLU and
    1e-6 without. Each call writes into an output filled with NaN first (an
    element the kernel never writes fails the check), and a second call on
    the same input must give the same bits (the cluster's merge has a fixed
    order). Each shape is timed in bf16 three ways: CUDA events over
    back-to-back calls (host enqueue included), the profiler's device time,
    and the host's enqueue per call; beside them the bound, the plain
    version and F.group_norm + F.silu (events and device time)."""
    worst = {"fp32": 0.0, "bf16": 0.0, "rel": 0.0}
    total = collections.Counter()
    per_shape, timed = [], {}
    for shape in list(shapes) + [sh for sh in K3_EXTRA_SHAPES if sh not in shapes]:
        c = shape[1]
        scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        for kind, dt in DTYPES.items():
            x = (2.0 * torch.randn(shape, generator=gen, device="cuda") + 0.5).to(dt)
            for eps, silu in ((1e-5, True), (1e-6, False)):
                with nan_filled_outputs():
                    out = group_norm_silu(x, scale, bias, 32, eps, silu)
                    again = group_norm_silu(x, scale, bias, 32, eps, silu)
                torch.cuda.synchronize()
                ref = group_norm_silu_plain(x, scale, bias, 32, eps, silu)
                err, rel, ok = within("K3", kind, out, ref, dt)
                if not ok:
                    fail(f"K3 disagrees with its plain version at {shape} {kind} "
                         f"eps={eps} silu={silu}: {err:.3e}, rel L2 {rel:.3e}")
                if not torch.equal(out, again):
                    fail(f"K3's two calls at {shape} {kind} eps={eps} silu={silu} differ")
                worst[kind] = max(worst[kind], err)
                if kind == "bf16":
                    worst["rel"] = max(worst["rel"], rel)
        x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        run = functools.partial(group_norm_silu, x, scale, bias, 32, 1e-5, True)
        lib = functools.partial(group_norm_silu_library, x, scale.to(x.dtype), bias.to(x.dtype))
        timed[shape] = ({"ms": time_ms(run), "host_us": host_us(run),
                         "plain_ms": time_ms(functools.partial(
                             group_norm_silu_plain, x, scale, bias, 32, 1e-5, True)),
                         "library_ms": time_ms(lib)}, run, lib)
    dev = device_ms_each({f"{fn} {shape}": f for shape, (_, run, lib) in timed.items()
                          for fn, f in (("K3", run), ("library", lib))})
    for shape, (t, _, _) in timed.items():
        count, c, numel = shapes.get(shape, 0), shape[1], math.prod(shape)
        t["device_ms"], t["library_device_ms"] = dev[f"K3 {shape}"], dev[f"library {shape}"]
        nbytes = 2 * numel * 2 + 2 * c * 4
        ops = 10.0 * numel  # stats, normalise, affine, SiLU: fp32 outside the tensor cores
        t["bound_ms"], by = bound_ms(nbytes, ops, "fp32")
        n, sl, resident = cluster_plan(c // 32 * shape[2] * shape[3], 2)
        print(f"  K3 bf16 (B,C,H,W)={shape} x{count}: cluster {n} x {sl} "
              f"({'resident' if resident else 'streaming'}); events {t['ms']:.4f} ms, "
              f"device {t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a call; bound "
              f"{t['bound_ms']:.4f} ms ({by}); plain {t['plain_ms']:.4f} ms; group_norm+silu "
              f"{t['library_ms']:.4f} ms (device {t['library_device_ms']:.4f}); "
              f"{nbytes / t['device_ms'] / 1e6:.0f} GB/s of device time", flush=True)
        per_shape.append({"shape": shape, "count": count, "cluster": n, "slice": sl,
                          "resident": resident, **t})
        for key, val in (*t.items(), ("ops", ops), ("bytes", nbytes), ("calls", 1)):
            total[key] += count * val
    print(f"  K3 max_abs_err fp32 {worst['fp32']:.3e} (tol {TOL['K3']['fp32']:.0e}), "
          f"bf16 {worst['bf16']:.3e} (tol {TOL['K3']['bf16']:.3e}), bf16 rel L2 "
          f"{worst['rel']:.3e} (tol {REL_TOL_BF16:.0e}), NaN-filled outputs, two calls "
          f"bit-equal ok", flush=True)
    print(f"  K3 per fused forward ({total['calls']} calls): events {total['ms']:.4f} ms, "
          f"device {total['device_ms']:.4f} ms, host {total['host_us'] / 1e3:.4f} ms; bound "
          f"{total['bound_ms']:.4f} ms; plain {total['plain_ms']:.4f} ms; group_norm+silu "
          f"{total['library_ms']:.4f} ms (device {total['library_device_ms']:.4f})", flush=True)
    _, by = bound_ms(total["bytes"], total["ops"], "fp32")
    return {"max_abs_err": worst["bf16"], "max_abs_err_fp32": worst["fp32"],
            "rel_l2_err": worst["rel"], "tol": TOL["K3"]["bf16"], "ms": total["ms"],
            "device_ms": total["device_ms"],
            "host_us_per_call": total["host_us"] / total["calls"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"], "bound_by": by,
            "library_ms": total["library_ms"],
            "library_device_ms": total["library_device_ms"], "per_shape": per_shape}


def check_groupnorm_unfused(gen) -> dict:
    """K3 with silu=False against group_norm_silu_plain at K3_UNFUSED_SHAPES,
    fp32 and bf16, eps 1e-5 and 1e-6, into NaN-filled outputs; and
    GroupNorm32's unfused norm on the same input: under inference_mode one
    K3 launch, bit-equal to the direct call, also on a channels-last copy;
    under autograd no launch, bit-equal to the plain version. fp32 is held
    to TOL, bf16 to K3_ULPS ulps of each |y| and to REL_TOL_BF16. Returns
    the worst errors."""
    worst = {"fp32": 0.0, "bf16": 0.0, "rel": 0.0, "ulps": 0.0}
    for shape in K3_UNFUSED_SHAPES:
        c = shape[1]
        gn = GroupNorm32(c, device="cuda")
        with torch.no_grad():
            gn.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda"))
            gn.bias.copy_(0.1 * torch.randn(c, generator=gen, device="cuda"))
        w, b = gn.weight.detach(), gn.bias.detach()
        for kind, dt in DTYPES.items():
            x = (2.0 * torch.randn(shape, generator=gen, device="cuda") + 0.5).to(dt)
            for eps in (1e-5, 1e-6):
                gn.eps = eps
                with nan_filled_outputs():
                    out = group_norm_silu(x, w, b, 32, eps, False)
                ref = group_norm_silu_plain(x, w, b, 32, eps, False)
                err, rel = errors(out, ref)
                if kind == "fp32":
                    ok = err <= TOL["K3"]["fp32"]
                else:
                    ulps = ulps_off_bf16(out, ref, K3_ULP_FLOOR)
                    ok = ulps <= K3_ULPS and rel <= REL_TOL_BF16
                    worst["rel"] = max(worst["rel"], rel)
                    worst["ulps"] = max(worst["ulps"], ulps)
                if not ok or out.dtype != dt:
                    fail(f"K3 (silu=False) disagrees with its plain version at {shape} {kind} "
                         f"eps={eps}: {err:.3e}, rel L2 {rel:.3e}"
                         + (f", {ulps:.2f} bf16 ulps of |y|" if kind == "bf16" else ""))
                worst[kind] = max(worst[kind], err)
                for layout in ("contiguous", "channels-last"):
                    xi = x if layout == "contiguous" else x.to(memory_format=torch.channels_last)
                    before = group_norm_silu.launches
                    with torch.inference_mode():
                        routed = gn(xi)
                    if group_norm_silu.launches - before != 1 or not torch.equal(routed, out):
                        fail(f"GroupNorm32 ({layout}) at {shape} {kind} eps={eps} under "
                             f"inference_mode: {group_norm_silu.launches - before} K3 launches, "
                             f"bit-equal to K3 {torch.equal(routed, out)}")
                xg = x.detach().requires_grad_()
                before = group_norm_silu.launches
                plain = gn(xg)
                if group_norm_silu.launches != before or not torch.equal(plain.detach(), ref):
                    fail(f"GroupNorm32 at {shape} {kind} eps={eps} under autograd did not take "
                         f"the plain version")
                del xg, plain
            del x
        torch.cuda.empty_cache()
    print(f"  K3 silu=False at {list(K3_UNFUSED_SHAPES)}, fp32 and bf16, eps 1e-5 and 1e-6: "
          f"max_abs_err fp32 {worst['fp32']:.3e} (tol {TOL['K3']['fp32']:.0e}), bf16 "
          f"{worst['bf16']:.3e}, {worst['ulps']:.2f} bf16 ulps of |y| (tol {K3_ULPS}, the ulp "
          f"at no less than |y| = {K3_ULP_FLOOR:g}), bf16 rel L2 {worst['rel']:.3e} (tol "
          f"{REL_TOL_BF16:.0e}); GroupNorm32 one K3 launch without autograd (channels-last "
          f"too), bit-equal; the plain version under autograd", flush=True)
    return {"max_abs_err": worst["bf16"], "max_abs_err_fp32": worst["fp32"],
            "ulps_bf16": worst["ulps"], "rel_l2_err": worst["rel"]}


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
    want_k3 = mode_plan(cfg, cfg.ddim_steps)["K3"]
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
        if d[0] != want_k1 or d[1] != k2_per_swap or d[2] != want_k3:
            fail(f"request {r}: K1 launched {d[0]} times (want {want_k1}), "
                 f"K2 {d[1]} (want {k2_per_swap}), K3 {d[2]} (want {want_k3})")
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
    grad=True runs fn with autograd on (a training step). Returns the
    kernel launches by kind."""
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
    kinds, launches = collections.Counter(), collections.Counter()
    for e in rows:
        name = e.key
        kind = ("K2/K2r d=512 attn_fwd_sm90" if "attn_fwd_sm90<512" in name else
                "K1 attn_fwd_sm90" if "attn_fwd_sm90" in name and ", true>" in name else
                "K2/K2r attn_fwd_sm90" if "attn_fwd_sm90" in name else
                "K4 d=512 flash_bwd_dkv_gemm" if "flash_bwd_dkv_gemm_sm90" in name else
                "K5 d=512 (with the shared dS/P)" if any(
                    w in name for w in ("flash_bwd_ds_sm90", "flash_bwd_dq_gemm_sm90")) else
                "K4 flash_bwd_dkv" if "flash_bwd_dkv" in name else
                "K5 flash_bwd_dq" if "flash_bwd_dq" in name else
                "K3 group_norm_sm90" if "group_norm_sm90" in name else
                "cuDNN NCHW<->NHWC" if "nchwToNhwc" in name or "nhwcToNchw" in name else
                "conv/gemm" if any(w in name for w in ("conv", "gemm", "sm90", "xmma", "cutlass", "dgrad", "implicit")) else
                "other")
        kinds[kind] += dev(e)
        launches[kind] += e.count
    busy = sum(kinds.values())
    print(f"  profile of that {what}: device kernels {busy:.2f} ms against "
          f"{wall:.2f} ms wall unprofiled ({100 * busy / wall:.1f}% busy), "
          f"{sum(e.count for e in rows)} kernel launches; by kind: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.most_common()), flush=True)
    for e in rows[:top]:
        print(f"    {dev(e):8.3f} ms {e.count:5d}x  {e.key[:90]}", flush=True)
    return launches


def fp32_copy(module, cls, config):
    """An fp32 `cls(config)` on the card holding `module`'s weights."""
    net = cls(config, device="cuda")
    net.load_state_dict(module.state_dict())
    return net.eval().requires_grad_(False)


def towers_vs_fp32(swapper, cfg: SwapConfig, k3_per_forward: int):
    """Each bf16 tower against an fp32 copy with the same weights, at full
    width: the UNet unfused and fused (K3), the VAE encoder (posterior mean)
    and decoder (fed the same latent), the conditioner. The fused forward is
    profiled too: the profiler must count one K3 kernel a call. Returns the
    fused forward's K3 launches."""
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
    profiled = profile_forward(lambda: fused(x9, t, ctx), what="fused forward")
    k3_kernels = profiled["K3 group_norm_sm90"]
    print(f"  K3 kernels in the profiled fused forward: {k3_kernels} (planned "
          f"{k3_per_forward}, one launch a call)", flush=True)
    if k3_kernels != k3_per_forward:
        fail(f"the profiler counted {k3_kernels} K3 kernels in the fused forward, "
             f"expected {k3_per_forward}")
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


# ------------------------------------------------------------------ phase 9

def serving_mode_configs() -> dict:
    """The swap's other serving modes at SwapConfig()'s widths (phase 9).
    Depth cut: the 1024 px tiles run DDIM-10, not 50."""
    base, rp = SwapConfig(), dataclasses.replace

    def quant(cfg, unet, vae, clip, **unet_kw):
        cond = cfg.conditioner
        return rp(cfg, unet=rp(cfg.unet, quant=unet, **unet_kw), vae=rp(cfg.vae, quant=vae),
                  conditioner=rp(cond, clip=rp(cond.clip, quant=clip)))

    dpm = rp(base, sampler="dpm", ddim_steps=20, ddim_discretize="lam_uniform")
    return {
        "PLMS-50": rp(base, sampler="plms"),
        "DPM-Solver++(2M)-20 lam_uniform": dpm,
        "DPM-Solver++(2M)-20 lam_uniform cfg_steps=8": rp(dpm, cfg_steps=8),
        "DDIM-50 int8 (--quant int8 --quant-cond)":
            quant(base, "int8", "int8", "int8", fused_groupnorm=True),
        "DDIM-50 int8conv (--quant int8conv --quant-cond)":
            quant(base, "int8conv", "int8conv", "int8", fused_groupnorm=True),
        "student DDIM-10 cfg 1.0 fast int8conv":
            rp(quant(base, "int8conv", "none", "int8", attn_impl="fast"), ddim_steps=10,
               cfg_scale=1.0),
        "1024 px tiles DDIM-10": rp(base, image_size=1024, latent_size=128, vae_tile=64,
                                    unet_tile=64, ddim_steps=10),
    }


def n_tiles(size: int, tile: int, stride: int) -> int:
    """Tiles of parallel/tiling.py over a size x size input (1 untiled)."""
    return len(tiling._starts(size, tile, stride)) ** 2 if tile and size > tile else 1


def unet_forwards(cfg: SwapConfig, steps: int) -> collections.Counter:
    """UNet forwards of one request by kind: "pair" (the CFG pair batch-
    doubled, 2B rows), "dedup" (B rows, doubled at the first context read),
    "cond" (the conditional half alone, B rows)."""
    use_cfg = cfg.cfg_scale != 1.0
    if cfg.sampler == "plms":  # one evaluation a step, two on step 0
        return collections.Counter({"pair" if use_cfg else "cond": steps + 1})
    n_cfg = (min(cfg.cfg_steps or steps, steps)) if use_cfg else 0
    pair = "dedup" if cfg.cfg_dedup and not cfg.unet_tile else "pair"
    return collections.Counter({pair: n_cfg, "cond": steps - n_cfg})


def norm_shapes(fn) -> collections.Counter:
    """(B, C, H, W) of each GroupNorm32 call in fn(), counted by a forward
    pre-hook while fn runs modules built on the meta device. On the card
    each call launches K3 once where autograd records nothing (ops/
    groupnorm.py::group_norm), and the plain version where it records."""
    seen = collections.Counter()

    def hook(module, args):
        if isinstance(module, GroupNorm32):
            seen[tuple(args[0].shape)] += 1

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        with torch.no_grad():
            fn()
    finally:
        handle.remove()
    return seen


_NORMS: dict = {}  # the meta runs' counts, by what they were run at


def _memo(key, run) -> collections.Counter:
    if key not in _NORMS:
        _NORMS[key] = run()
    return collections.Counter(_NORMS[key])


def unet_norms(u, rows: int, latent: int, dedup: bool = False) -> collections.Counter:
    """K3's launches by shape in one UNet forward of `rows` latents (dedup:
    the rows doubled at the first context read). Fused or int8, the norms
    see the same shapes: the meta copy is the plain UNet."""
    def run():
        unet = UNetModel(dataclasses.replace(u, fused_groupnorm=False, quant="none"),
                         device="meta")
        meta = functools.partial(torch.zeros, device="meta")
        ctx = meta((2 * rows if dedup else rows, 1, u.context_dim))
        return norm_shapes(lambda: unet(meta((rows, u.in_channels, latent, latent)),
                                        meta((rows,), dtype=torch.long), ctx, cfg_expand=dedup))

    return _memo(("unet", repr(u), rows, latent, dedup), run)


def vae_norms(v: VAEConfig, batch: int, size: int):
    """K3's launches by shape in one VAE encode of `batch` size x size
    images and in one decode of their latents: (encode, decode)."""
    vae = AutoencoderKL(dataclasses.replace(v, quant="none"), device="meta")
    lat = size // 2 ** (len(v.ch_mult) - 1)
    key = (repr(v), batch, size)
    return (_memo(("encode", *key), lambda: norm_shapes(
                lambda: vae.encode(torch.zeros(batch, 3, size, size, device="meta")))),
            _memo(("decode", *key), lambda: norm_shapes(
                lambda: vae.decode(torch.zeros(batch, v.embed_dim, lat, lat, device="meta")))))


def landmark_norms(lcfg: LandmarkNetConfig, batch: int) -> collections.Counter:
    """K3's launches by shape in one LandmarkNet forward at `batch`."""
    net = LandmarkNet(lcfg, device="meta")
    s = lcfg.input_size
    return norm_shapes(lambda: net(torch.zeros(batch, 3, s, s, device="meta")))


def scaled(c, k: int) -> collections.Counter:
    return collections.Counter({key: k * v for key, v in c.items()})


def mode_plan(cfg: SwapConfig, steps: int, batch: int = BATCH) -> dict:
    """Launches of one request, from the config: K1 by (BH, N, D) (each
    self-attention of 512 tokens or more, in order: 2 x num_res_blocks + 1
    SpatialTransformers at each attention level, the middle block's; under
    the dedup the first runs at the half batch), K2 by (BH, N, M, D) (the
    VAE encoder's and decoder's mid-block, over all VAE tiles in one call),
    K3 by count and, as "K3 shapes", by (B, C, H, W) (every GroupNorm32 of
    the UNet's forwards, the encode and the decode: all without autograd)."""
    u = cfg.unet
    tiled = cfg.unet_tile and cfg.latent_size > cfg.unet_tile
    lat = cfg.unet_tile if tiled else cfg.latent_size
    t = n_tiles(cfg.latent_size, cfg.unet_tile, cfg.unet_tile_stride or cfg.unet_tile // 2)
    levels = len(u.channel_mult)
    attn = [(lat // 2**i, u.channel_mult[i], (2 * u.num_res_blocks + 1) * u.transformer_depth)
            for i in range(levels) if 2**i in u.attention_resolutions]
    attn.append((lat // 2 ** (levels - 1), u.channel_mult[-1], u.transformer_depth))  # middle
    k1, k3 = collections.Counter(), collections.Counter()
    forwards = unet_forwards(cfg, steps)
    for kind, count in forwards.items():
        rows = {"pair": 2 * batch * t, "dedup": 2 * batch, "cond": batch * t}[kind]
        first = kind == "dedup"
        k3 += scaled(unet_norms(u, rows // 2 if first else rows, lat, dedup=first), count)
        for side, mult, blocks in attn:
            n, d = side**2, u.model_channels * mult // u.num_heads
            for _ in range(blocks):
                if n >= 512 and d <= 256:
                    k1[((rows // 2 if first else rows) * u.num_heads, n, d)] += count
                first = False
    vae_lat = cfg.vae_tile if cfg.vae_tile and cfg.latent_size > cfg.vae_tile else cfg.latent_size
    tv = n_tiles(cfg.latent_size, cfg.vae_tile, cfg.vae_tile_stride or cfg.vae_tile // 2)
    d2 = cfg.vae.ch * cfg.vae.ch_mult[-1]
    k2 = collections.Counter({(batch * tv, vae_lat**2, vae_lat**2, d2): 2})
    enc, dec = vae_norms(cfg.vae, batch * tv, vae_lat * 2 ** (len(cfg.vae.ch_mult) - 1))
    k3 += enc + dec
    return {"K1": k1, "K2": k2, "K3": sum(k3.values()), "K3 shapes": k3,
            "forwards": sum(forwards.values())}


def int8_layers(module) -> list:
    return [m for m in module.modules() if getattr(m, "int8", False)]


def serve_mode(name: str, cfg: SwapConfig, params: dict):
    """One warm-up and one timed batch-2 request of a mode through
    FaceSwapper.swap, the counts set to 0 before each and read after; the
    output and every launch (K1 and K2 by shape, K3 and the int8 products
    by count) held to the plan from the config. Returns (stats, swapper)."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    swapper = FaceSwapper(cfg, params=params, device=dev)
    build_s = time.perf_counter() - t0
    steps = swapper.tables.num_steps
    plan = mode_plan(cfg, steps)
    unet_q, enc_q, dec_q, cond_q = (len(int8_layers(m)) for m in (
        swapper.unet, swapper.vae.encoder, swapper.vae.decoder, swapper.conditioner))
    plan["int8 products"] = unet_q * plan["forwards"] + enc_q + dec_q + cond_q
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for r in range(2):
        req = make_request(20 + r, cfg.image_size, dev)
        gen = torch.Generator(device=dev).manual_seed(r)
        reset_counts()  # this mode's run starts here
        PQ.int_mm.launches = 0
        for k in KERNELS[:2]:
            k.shapes = collections.Counter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = swapper.swap(**req, generator=gen)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        got = {"K1": KERNELS[0].shapes, "K2": KERNELS[1].shapes, "K3": counts()[2],
               "int8 products": PQ.int_mm.launches}
        for k in KERNELS[:2]:
            k.shapes = None
        s = cfg.image_size
        ok = (out.shape == (BATCH, s, s, 3) and bool(torch.isfinite(out).all())
              and float(out.abs().max()) <= 1.0)
        if not ok:
            fail(f"{name}: output not finite ({BATCH},{s},{s},3) in [-1,1]")
        bad = [k for k in got if got[k] != plan[k]]
        if bad:
            fail(f"{name}: launches {[(k, got[k], plan[k]) for k in bad]} (got, planned)")
    peak = torch.cuda.max_memory_allocated()
    stats = {"steps": steps, "unet_forwards": plan["forwards"], "first_s": lat[0],
             "steady_s": lat[1], "swaps_per_s": BATCH / lat[1], "peak_gib": peak / 2**30,
             "build_s": build_s, "K1": sum(got["K1"].values()), "K2": sum(got["K2"].values()),
             "K3": got["K3"], "int8_products": got["int8 products"],
             "K1_shapes": {str(k): v for k, v in got["K1"].items()},
             "K2_shapes": {str(k): v for k, v in got["K2"].items()}}
    print(f"  {name}: {steps} steps, {plan['forwards']} UNet forwards; first {lat[0]:.3f} s, "
          f"steady {lat[1]:.3f} s, {BATCH / lat[1]:.3f} swaps/s, peak {peak / 2**30:.2f} GiB; "
          f"launches K1 {stats['K1']} {dict(got['K1'])}, K2 {stats['K2']} {dict(got['K2'])}, "
          f"K3 {got['K3']}, int8 products {got['int8 products']} (all as planned); output "
          f"finite in [-1,1], std {out.float().std().item():.4f}", flush=True)
    return stats, swapper


def int8_product_checks(swapper, cfg: SwapConfig, params: dict, mode: str) -> dict:
    """The int8 path of one full-width UNet forward (batch 2, dedup): the
    card's int8 product (torch._int_mm) bit-equal to int_mm_plain at each of
    its (M, K, N), on random int8 operands over the full range; each int8
    layer's dequantised output equal with either product; the forward
    against the bf16 forward with the same weights (INT8_TOL); per shape
    class, _int_mm, the whole int8 site and the bf16 product it replaces,
    timed. Returns the numbers."""
    x9, t, ctx2 = unet_inputs(cfg, seed=31, ctx_batch=2 * BATCH)
    classes = collections.Counter()
    hooks = [m.register_forward_hook(lambda m, a, o: classes.update(
        [(type(m).__name__, tuple(a[0].shape), tuple(m.weight.shape))]))
        for m in int8_layers(swapper.unet)]
    PQ.int_mm.shapes = collections.Counter()
    with torch.inference_mode():
        swapper.unet(x9, t, ctx2, cfg_expand=True)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    mm_shapes, PQ.int_mm.shapes = PQ.int_mm.shapes, None
    g = torch.Generator(device="cuda").manual_seed(5)
    for (m, k, n) in mm_shapes:
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        if not torch.equal(PQ.int_mm(a, w), PQ.int_mm_plain(a, w)):
            fail(f"{mode}: torch._int_mm differs from int_mm_plain at (M,K,N)=({m},{k},{n})")
    # every int8 layer with either product: the same dequantised output
    outs = {}
    for key, mm in (("int_mm", KERNEL_INT_MM), ("int_mm_plain", PQ.int_mm_plain)):
        PQ.int_mm = mm  # int8_dense_q and int8_conv_q look it up at each call
        layer_out = []
        hooks = [m.register_forward_hook(lambda m, a, o: layer_out.append(o.clone()))
                 for m in int8_layers(swapper.unet)]
        try:
            with torch.inference_mode():
                swapper.unet(x9, t, ctx2, cfg_expand=True)
        finally:
            PQ.int_mm = KERNEL_INT_MM
            for h in hooks:
                h.remove()
        outs[key] = layer_out
    same = (len(outs["int_mm"]) == sum(mm_shapes.values())
            and all(torch.equal(a, b) for a, b in zip(outs["int_mm"], outs["int_mm_plain"])))
    print(f"  {mode}: int8 products of one UNet forward (dedup, batch {BATCH}): "
          f"{sum(mm_shapes.values())} over {len(mm_shapes)} (M,K,N), _int_mm bit-equal to "
          f"int_mm_plain at each; {len(outs['int_mm'])} int8 layers' outputs equal with "
          f"either product: {same}", flush=True)
    if not same:
        fail(f"{mode}: an int8 layer's output depends on which exact product ran")
    # the whole forward against bf16 with the same weights
    plain = UNetModel(dataclasses.replace(cfg.unet, quant="none"), device="cuda")
    plain.load_state_dict(params["unet"])
    x9, t, ctx = unet_inputs(cfg, seed=33, ctx_batch=BATCH)
    with torch.inference_mode():
        rel = errors(swapper.unet(x9, t, ctx), plain(x9, t, ctx))[1]
    del plain
    print(f"  {mode}: full-width UNet forward vs the bf16 forward, same weights: rel L2 "
          f"{rel:.4e} (tol {INT8_TOL[mode]:.0e})", flush=True)
    if not rel <= INT8_TOL[mode]:
        fail(f"{mode}: the int8 UNet forward is further from bf16 than {INT8_TOL[mode]}")
    # per shape class: _int_mm, the whole int8 site, the bf16 product
    rows, total = [], collections.Counter()
    for (kind, xs, ws), count in sorted(classes.items(), key=lambda kv: -kv[1]):
        x = torch.randn(xs, generator=g, device="cuda", dtype=torch.bfloat16)
        w = torch.randn(ws, generator=g, device="cuda", dtype=torch.bfloat16) * 0.05
        if kind == "Linear":
            wq, wsc = PQ.quant_int8(w, dim=1)
            a = torch.randint(-127, 128, (math.prod(xs[:-1]), xs[-1]), generator=g,
                              device="cuda", dtype=torch.int8)
            site = lambda: PQ.int8_dense_q(x, wq, wsc, out_dtype=torch.bfloat16)
            bf16 = lambda: F.linear(x, w)
            mkn = (a.shape[0], ws[1], ws[0])
        else:
            k, pad = ws[-1], ws[-1] // 2
            wq, wsc = PQ.conv_weight_q(w)
            a = torch.randint(-127, 128, (xs[0] * xs[2] * xs[3], wq.shape[1]), generator=g,
                              device="cuda", dtype=torch.int8)
            site = lambda: PQ.int8_conv_q(x, wq, wsc, k, pad, out_dtype=torch.bfloat16)
            bf16 = lambda: F.conv2d(x, w, padding=pad)
            mkn = (a.shape[0], wq.shape[1], ws[0])
        t_mm = time_ms(lambda: PQ.int_mm(a, wq), budget_ms=20.0)
        t_site, t_bf16 = time_ms(site, budget_ms=20.0), time_ms(bf16, budget_ms=20.0)
        ops = 2.0 * math.prod(mkn)
        rows.append({"kind": kind, "x": xs, "w": ws, "mkn": mkn, "count": count,
                     "int_mm_ms": t_mm, "int8_site_ms": t_site, "bf16_ms": t_bf16})
        for key, val in (("int_mm_ms", t_mm), ("int8_site_ms", t_site), ("bf16_ms", t_bf16)):
            total[key] += count * val
        print(f"    {kind} x{count} x {xs} w {ws} (M,K,N)={mkn}: _int_mm {t_mm:.4f} ms "
              f"({ops / t_mm / 1e9:.0f} TOP/s), int8 site {t_site:.4f} ms, bf16 "
              f"{'F.linear' if kind == 'Linear' else 'F.conv2d'} {t_bf16:.4f} ms", flush=True)
    print(f"  {mode}: per UNet forward, {sum(classes.values())} int8 sites: _int_mm "
          f"{total['int_mm_ms']:.3f} ms, the int8 sites {total['int8_site_ms']:.3f} ms, the "
          f"bf16 products they replace {total['bf16_ms']:.3f} ms", flush=True)
    return {"rel_l2_vs_bf16": rel, "products_per_forward": sum(mm_shapes.values()),
            "per_forward_ms": dict(total), "classes": rows}


def tiny_modes_reference():
    """Every mode at the tiny fp32 config on the card against the port on
    the CPU (phase 5's config, 256 px, fused GroupNorm): PLMS, DPM-Solver++
    on lam_uniform with cfg_steps, the VAE and UNet tiles, the student rung
    (cfg 1.0, fast attention), each within 1e-3 as phase 5; int8 site by
    site: each int8 layer's input on the card fed to the CPU copy of the
    layer, its output equal within 1e-6 of its largest (the same fp32
    operations on identical int8 operands), since a whole int8 forward
    cannot be held tightly (a quantisation boundary that the two devices'
    float layers place a few ulps apart carries on through every later
    site); and fold(unfold(x)) == x on the card."""
    base = tiny_swap_config(image_size=256, ddim_steps=2)
    rp = dataclasses.replace
    base = rp(base, sample_posterior=False,
              unet=rp(base.unet, fused_groupnorm=True),
              vae=rp(base.vae, ch=32, ch_mult=(1, 2, 4, 16)))
    modes = {
        "PLMS-4": rp(base, sampler="plms", ddim_steps=4),
        "DPM-4 lam_uniform cfg_steps=2": rp(base, sampler="dpm", ddim_steps=4,
                                            ddim_discretize="lam_uniform", cfg_steps=2),
        "tiles 16": rp(base, vae_tile=16, unet_tile=16),
        "student DDIM-4 cfg 1.0 fast": rp(base, ddim_steps=4, cfg_scale=1.0,
                                          unet=rp(base.unet, attn_impl="fast")),
    }
    req = make_request(7, 256, "cpu")
    req["x_T"] = torch.randn((BATCH, 32, 32, 4), generator=torch.Generator().manual_seed(7))
    worst = {}
    for name, cfg in modes.items():
        card = FaceSwapper(cfg, device="cuda")
        for i, m in enumerate(card.towers().values()):
            init_params(m, seed=40 + i, dezero=True)
        cpu = FaceSwapper(cfg, device="cpu")
        cpu.load_params({n: {k: v.cpu() for k, v in m.state_dict().items()}
                         for n, m in card.towers().items()})
        reset_counts()
        out = card.swap(**{k: v.cuda() for k, v in req.items()})
        torch.cuda.synchronize()
        launched = counts()
        err = (out.cpu() - cpu.swap(**req)).abs().max().item()
        worst[name] = err
        print(f"  tiny 256 px {name}, card vs CPU: max abs err {err:.3e} (tol 1e-3); "
              f"launches K1 {launched[0]} K2 {launched[1]} K3 {launched[2]}", flush=True)
        if not err <= 1e-3:
            fail(f"tiny {name}: the card disagrees with the CPU port")
    # int8 site by site, and the whole forward's distance from fp32
    for quant in ("int8", "int8conv"):
        ucfg = rp(base.unet, quant=quant)
        card = UNetModel(ucfg, device="cuda")
        init_params(card, seed=50, dezero=True)
        cpu = UNetModel(ucfg)
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        seen = []
        hooks = [m.register_forward_hook(lambda m, a, o: seen.append((m, a[0].clone(), o.clone())))
                 for m in int8_layers(card)]
        g = torch.Generator().manual_seed(8)
        x9, t, ctx = (torch.randn((BATCH, 9, 32, 32), generator=g),
                      torch.randint(1, 1000, (BATCH,), generator=g),
                      torch.randn((BATCH, 1, 768), generator=g))
        with torch.inference_mode():
            card(x9.cuda(), t.cuda(), ctx.cuda())
        for h in hooks:
            h.remove()
        by_id = dict(zip(map(id, card.modules()), cpu.modules()))
        site_err = 0.0
        with torch.inference_mode():
            for m, a, o in seen:
                ref = by_id[id(m)](a.cpu())
                site_err = max(site_err, ((o.cpu() - ref).abs().max() / ref.abs().max()).item())
        print(f"  tiny UNet {quant} on the card: {len(seen)} int8 sites, each against the CPU "
              f"layer on the card's input: max error {site_err:.3e} of the site's largest "
              f"output (tol 1e-6)", flush=True)
        if len(seen) != len(int8_layers(card)) or not site_err <= 1e-6:
            fail(f"tiny {quant}: an int8 site on the card disagrees with the CPU port")
        worst[f"int8 sites {quant}"] = site_err
    x = torch.randn((BATCH, 9, 128, 128), device="cuda")
    tiles, meta = tiling.unfold(x, 64, 32)
    err = ((tiling.fold(tiles, meta) - x).abs().max() / x.abs().max()).item()
    print(f"  fold(unfold(x)) on the card, (2,9,128,128) in 9 tiles of 64 at stride 32: "
          f"max error {err:.3e} of max |x| (tol 1e-6: the weighted mean's fp32 rounding, "
          f"a few ulps)", flush=True)
    if not err <= 1e-6:
        fail("fold(unfold(x)) != x on the card")
    worst["fold(unfold(x))"] = err
    return worst


def zero_tile_encode(params: dict) -> dict:
    """ROADMAP C2 at full width: the 1024 px tiles mode's tiled VAE encode
    (512 px tiles at stride 256) of an image whose centre tile is all zero,
    bf16 against an fp32 copy with the same weights, and that tile alone;
    held to phase 4's VAE-encode tolerance."""
    cfg = serving_mode_configs()["1024 px tiles DDIM-10"]
    vae = AutoencoderKL(cfg.vae, device="cuda").eval().requires_grad_(False)
    vae.load_state_dict(params["vae"])
    vae32 = fp32_copy(vae, AutoencoderKL, dataclasses.replace(cfg.vae, dtype=torch.float32))
    f = cfg.image_size // cfg.latent_size
    tile, stride = cfg.vae_tile * f, (cfg.vae_tile_stride or cfg.vae_tile // 2) * f
    g = torch.Generator(device="cuda").manual_seed(50)
    img = torch.rand((1, 3, cfg.image_size, cfg.image_size), generator=g, device="cuda") * 2 - 1
    img[:, :, stride:stride + tile, stride:stride + tile] = 0.0
    enc = lambda v: lambda x: v.encode(x).mode() * SD_SCALE_FACTOR
    out = {}
    with torch.inference_mode():
        for name, x, run in (
                ("tiled encode, centre tile all zero", img,
                 lambda v, x: tiling.tiled_apply(enc(v), x, tile, stride, out_channels=4,
                                                 scale=1.0 / f)),
                ("the all-zero 512 px tile alone", img[:, :, stride:stride + tile,
                                                       stride:stride + tile],
                 lambda v, x: enc(v)(x))):
            a, b = run(vae, x), run(vae32, x)
            err, rel = errors(a, b)
            ok = bool(torch.isfinite(a).all()) and rel <= TOWER_TOL["VAE encode"]
            out[name] = {"max_abs": err, "rel_l2": rel}
            print(f"  ROADMAP C2, {name}: bf16 {tuple(a.shape)} vs fp32 rel L2 {rel:.4e} (tol "
                  f"{TOWER_TOL['VAE encode']:.0e}), max abs {err:.4e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"bf16 VAE encode, {name}: further from fp32 than the tolerance")
    del vae, vae32
    return out


def serving_modes(params: dict, gen):
    """Phase 9. Returns (per-mode stats, the K1/K2 entries at the tiled
    shapes, the int8 checks, the tiny checks, the all-zero tile's bf16
    against fp32)."""
    stats, int8 = {}, {}
    for name, cfg in serving_mode_configs().items():
        st, swapper = serve_mode(name, cfg, params)
        stats[name] = st
        if cfg.unet.quant != "none" and cfg.cfg_scale != 1.0:
            int8[name] = int8_product_checks(swapper, cfg, params, cfg.unet.quant)
        del swapper
        torch.cuda.empty_cache()
    tiled = stats["1024 px tiles DDIM-10"]
    as_shapes = lambda d: collections.Counter({eval(k): v for k, v in d.items()})
    k1 = collections.Counter({(bh, n, n, d): c // 10 for (bh, n, d), c in
                              as_shapes(tiled["K1_shapes"]).items()})
    k2 = as_shapes(tiled["K2_shapes"])
    print("  K1 and K2 at the tiled shapes (per UNet forward / per swap) against their "
          "plain versions", flush=True)
    entries = {"K1": check_attention("K1", self_attention_smalld, k1, [], gen),
               "K2": check_attention("K2", wide_attention, k2, [], gen)}
    tiny = tiny_modes_reference()
    zero = zero_tile_encode(params)
    return stats, entries, int8, tiny, zero


# ------------------------------------------------------------------ phase 10

# The raw-image path (RawSwapPipeline) at RawPipelineConfig()'s widths:
# swap_images on batch-2 1024 x 1024 frames and sources (LandmarkNet on the
# card), swap_images_robust on batches of 4 1080 x 1920 frames with a host
# landmark function (the ERT's hook) that places a 68-point face.
RAW_SIZE = 1024
FRAME_HW = (1080, 1920)
ROBUST_BATCH = 4
# forced presence of the robust batches: a pass-through frame, the carry
# inside a batch and across the two
ROBUST_PRESENCE = ([False, True, False, True], [False, False, True, False])
# bf16 BiSeNet and LandmarkNet against fp32 copies with the same weights,
# random weights, on the timed request's crops and frames: the share of
# pixels whose class agrees (seen 0.9929 on the H100), and the largest
# landmark distance in px at 1024 px (seen 0.378); the limits allow about
# twice the disagreement and 2.5 times the distance
RAW_BF16_TOL = {"class agreement": 0.985, "landmark px": 1.0}
# the tiny fp32 raw path, card against the CPU port (as phase 5's swap)
RAW_TINY_TOL = 1e-3


def face_template() -> torch.Tensor:
    """A 68-point face (iBUG order) in [0,1]^2, x right, y down: jaw arc,
    brows, nose, eyes, outer and inner lips."""
    pts = [[0.5 + 0.38 * math.cos(math.pi * (1 - i / 16)),
            0.47 + 0.45 * math.sin(math.pi * (1 - i / 16))] for i in range(17)]
    for side in (-1, 1):
        pts += [[0.5 + side * (0.17 + (i / 4 - 0.5) * 0.16),
                 0.30 - 0.035 * (1 - (i / 2 - 1) ** 2)] for i in range(5)]
    pts += [[0.5, 0.36 + i * 0.055] for i in range(4)]
    pts += [[0.5 + (i - 2) * 0.035, 0.555 + 0.012 * (1 - abs(i - 2))] for i in range(5)]
    for side in (-1, 1):
        pts += [[0.5 + side * 0.17 + 0.055 * math.cos(math.pi * i / 3),
                 0.385 + 0.025 * math.sin(math.pi * i / 3)] for i in range(6)]
    for n, rx, ry in ((12, 0.10, 0.045), (8, 0.065, 0.02)):
        pts += [[0.5 + rx * math.cos(2 * math.pi * i / n),
                 0.70 + ry * math.sin(2 * math.pi * i / n)] for i in range(n)]
    return torch.tensor(pts)


def template_landmarks(images):
    """A host landmark_fn: the face template over the middle half of each
    (B, H, W, 3) frame (numpy, as the ERT returns)."""
    b, h, w = images.shape[:3]
    pts = (face_template() - 0.5) * 0.5 * min(h, w) + torch.tensor([w / 2, h / 2])
    return pts.expand(b, 68, 2).numpy()


def with_x_T(swapper, x_T):
    """Wrap swapper.swap to take the first rows of a fixed x_T, moved to the
    swapper's device."""
    swap = swapper.swap
    swapper.swap = lambda **kw: swap(
        **kw, x_T=x_T[:kw["target_image"].shape[0]].to(swapper.device))


def raw_frames(seed: int, b: int, h: int, w: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((b, h, w, 3), generator=g, device="cuda")


def check_raw_output(name, out, frames, quads, passthrough=()):
    """The frame's shape, finite, in [0,1]; every quad finite with area > 0;
    pass-through frames equal to their input."""
    q = torch.as_tensor(quads, dtype=torch.float32)
    x, y = q[..., 0], q[..., 1]
    area = 0.5 * (x * y.roll(-1, 1) - x.roll(-1, 1) * y).sum(1).abs()
    ok = (out.shape == frames.shape and bool(torch.isfinite(out).all())
          and float(out.min()) >= 0.0 and float(out.max()) <= 1.0
          and bool(torch.isfinite(q).all()) and bool((area > 0).all())
          and all(torch.equal(out[i], frames[i]) for i in passthrough))
    if not ok:
        fail(f"{name}: output not finite {tuple(frames.shape)} in [0,1], a quad not finite "
             f"with area > 0, or a pass-through frame changed")
    return area


def raw_stages(pipe, target, source, gen):
    """One swap_images request stage by stage, CUDA events between the
    stages: {stage: ms}, and the output."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    with torch.inference_mode():
        torch.cuda.synchronize()
        tgt = target.permute(0, 3, 1, 2)
        ev[0].record()
        lm = pipe._landmarks(tgt)
        ev[1].record()
        crop, quads = pipe._align(tgt, lm)
        ev[2].record()
        ref = pipe._source_reference(source)
        ev[3].record()
        face = pipe._face_mask(pipe._parse(crop))
        ev[4].record()
        out_big = pipe._swap_crops(crop, face, ref, gen, True)
        ev[5].record()
        out = paste_back(tgt, out_big, quads).permute(0, 2, 3, 1)
        ev[6].record()
        ev[6].synchronize()
    names = ("landmarks", "align", "source reference", "parse", "swap", "paste back")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}, out


def raw_bf16_vs_fp32(pipe, target):
    """bf16 BiSeNet and LandmarkNet against fp32 copies with the same
    weights, on the request's aligned crops."""
    f32 = torch.float32
    rp = dataclasses.replace
    cfg = pipe.config
    bisenet32 = BiSeNet(rp(cfg.bisenet, dtype=f32), device="cuda")
    bisenet32.load_state_dict(pipe.bisenet.state_dict())
    lmnet32 = LandmarkNet(rp(cfg.landmark, dtype=f32), device="cuda")
    lmnet32.load_state_dict(pipe.landmark_net.state_dict())
    with torch.inference_mode():
        tgt = target.permute(0, 3, 1, 2)
        crop, _ = pipe._align(tgt, pipe._landmarks(tgt))
        p = cfg.parse_size
        small = resize_bilinear_aa(crop, p, p)
        seg16 = parse_faces(pipe.bisenet, small)
        seg32 = parse_faces(bisenet32.eval(), small)
        s = cfg.landmark.input_size
        x = resize_bilinear_aa(tgt, s, s) * 2 - 1
        scale = tgt.shape[-1] / s
        dist = ((pipe.landmark_net(x) - lmnet32.eval()(x)).reshape(-1, 68, 2) * scale).norm(dim=-1)
    agree = (seg16 == seg32).float().mean().item()
    px = dist.max().item()
    print(f"  bf16 vs fp32, same weights: BiSeNet class agreement {agree:.4f} at "
          f"{tuple(seg16.shape)} ({len(seg32.unique())} classes; limit >= "
          f"{RAW_BF16_TOL['class agreement']}), LandmarkNet largest distance {px:.4f} px, "
          f"mean {dist.mean().item():.4f} px at {RAW_SIZE} px (limit "
          f"{RAW_BF16_TOL['landmark px']})", flush=True)
    if not (agree >= RAW_BF16_TOL["class agreement"] and px <= RAW_BF16_TOL["landmark px"]):
        fail("bf16 BiSeNet or LandmarkNet too far from its fp32 copy")
    return {"bisenet_class_agreement": agree, "landmark_max_px": px,
            "landmark_mean_px": dist.mean().item()}


def raw_request_launches(name, plan):
    """The launches of one request, read after it ran, against the plan:
    K1 and K2 by shape, K3 by count."""
    got = {"K1": KERNELS[0].shapes, "K2": KERNELS[1].shapes, "K3": counts()[2]}
    for k in KERNELS[:2]:
        k.shapes = None
    bad = [k for k in got if got[k] != plan[k]]
    if bad:
        fail(f"{name}: launches {[(k, got[k], plan[k]) for k in bad]} (got, planned)")
    return {"K1": sum(got["K1"].values()), "K2": sum(got["K2"].values()), "K3": got["K3"]}


def start_request():
    reset_counts()
    for k in KERNELS[:2]:
        k.shapes = collections.Counter()


def raw_tiny_reference():
    """The tiny fp32 raw path (tiny_raw_config, tiny_swap_config(64, 2),
    sample_posterior off, the same x_T) on the card against the CPU port
    with the same weights: detect_landmarks and parse, swap_images and
    swap_images_robust (both one_program values, a forced presence pattern)
    with the host landmark function, swap_frame_multiface on fixed boxes,
    and detect_faces' boxes equal."""
    cfg = dataclasses.replace(tiny_swap_config(64, 2), sample_posterior=False)
    card_sw = FaceSwapper(cfg, device="cuda")
    for i, m in enumerate(card_sw.towers().values()):
        init_params(m, seed=60 + i, dezero=True)
    cpu_sw = FaceSwapper(cfg, device="cpu")
    cpu_sw.load_params({n: {k: v.cpu() for k, v in m.state_dict().items()}
                        for n, m in card_sw.towers().items()})
    card = RawSwapPipeline(card_sw, tiny_raw_config(), seed=7, device="cuda")
    cpu = RawSwapPipeline(cpu_sw, tiny_raw_config(), device="cpu",
                          landmark_params={k: v.cpu() for k, v in
                                           card.landmark_net.state_dict().items()},
                          bisenet_params={k: v.cpu() for k, v in
                                          card.bisenet.state_dict().items()})
    g = torch.Generator().manual_seed(9)
    x_T = torch.randn((4, 8, 8, 4), generator=g)
    tgt, src = torch.rand((4, 96, 96, 3), generator=g), torch.rand((2, 80, 80, 3), generator=g)
    frame = torch.rand((96, 128, 3), generator=g)
    for p in (card, cpu):
        with_x_T(p.swapper, x_T)
    err = {}
    worst = lambda a, b: (a.cpu().float() - b.float()).abs().max().item()
    err["detect_landmarks (px)"] = worst(card.detect_landmarks(tgt), cpu.detect_landmarks(tgt))
    err["parse (classes differing)"] = float(
        (card.parse(tgt).cpu() != cpu.parse(tgt)).sum().item())
    boxes = card.detect_faces(frame, max_faces=3)
    if boxes != cpu.detect_faces(frame, max_faces=3):
        fail(f"detect_faces: the card's boxes {boxes} differ from the CPU port's")
    for p in (card, cpu):
        p.landmark_fn = template_landmarks
    err["swap_images"] = worst(card.swap_images(tgt[:2], src), cpu.swap_images(tgt[:2], src))
    for one_program in (True, False):
        states = [None, None]
        for r, presence in enumerate(ROBUST_PRESENCE):
            outs = []
            for i, p in enumerate((card, cpu)):
                p.face_presence = lambda t, min_area_frac=2e-3, pr=presence: torch.tensor(pr)
                out, states[i], _ = p.swap_images_robust(tgt, src[:1].expand(4, -1, -1, -1),
                                                         state=states[i],
                                                         one_program=one_program)
                outs.append(out)
            err[f"swap_images_robust one_program={one_program} batch {r}"] = worst(*outs)
    fixed = [(4, 6, 60, 62), (70, 30, 120, 80)]
    for p in (card, cpu):
        p.detect_faces = lambda f, max_faces=4: fixed
    err["swap_frame_multiface"] = worst(card.swap_frame_multiface(frame, src[:1]),
                                        cpu.swap_frame_multiface(frame, src[:1]))
    print("  tiny fp32 raw path, card vs CPU (max abs on [0,1] frames; tol "
          f"{RAW_TINY_TOL:.0e}): " + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
          + f"; detect_faces boxes equal {boxes}", flush=True)
    bad = [k for k, v in err.items() if not v <= (0 if "classes" in k else RAW_TINY_TOL)]
    if bad:
        fail(f"the card's tiny raw path disagrees with the CPU port: {bad}")
    return err


def raw_path(params: dict) -> dict:
    """Phase 10. Returns its stats. Empties `params` once the swapper holds
    the weights, so that the peak memory counts one copy of them."""
    dev = torch.device("cuda")
    cfg = SwapConfig()
    t0 = time.perf_counter()
    swapper = FaceSwapper(cfg, params=params, device=dev)
    params.clear()  # from here the swapper holds the only copy of the weights
    pipe = RawSwapPipeline(swapper, RawPipelineConfig(), seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_bisenet = sum(p.numel() for p in pipe.bisenet.parameters())
    n_lm = sum(p.numel() for p in pipe.landmark_net.parameters())
    print(f"  built RawPipelineConfig() (align {pipe.config.align_size}, parse "
          f"{pipe.config.parse_size}, LandmarkNet {pipe.config.landmark.input_size} px widths "
          f"{pipe.config.landmark.widths}) on phase 3's towers in {time.perf_counter() - t0:.1f} "
          f"s: BiSeNet {n_bisenet:,} params, LandmarkNet {n_lm:,} params, bf16", flush=True)
    stats = {"bisenet_params": n_bisenet, "landmark_net_params": n_lm}

    # swap_images: one warm-up and one timed batch-2 request
    target, source = raw_frames(30, BATCH, RAW_SIZE, RAW_SIZE), raw_frames(31, BATCH, RAW_SIZE,
                                                                          RAW_SIZE)
    plan = mode_plan(cfg, cfg.ddim_steps)
    # LandmarkNet three times a request (target, source, the swap-size crop)
    plan["K3"] += 3 * sum(landmark_norms(pipe.config.landmark, BATCH).values())
    lat = []
    torch.cuda.reset_peak_memory_stats()
    for r in range(2):
        start_request()  # this request's run starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.swap_images(target, source, generator=torch.Generator(device=dev).manual_seed(r))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        launches = raw_request_launches(f"swap_images request {r}", plan)
        lm = pipe.detect_landmarks(target)
        _, quads = pipe.align(target, lm)
        area = check_raw_output(f"swap_images request {r}", out, target, quads)
    peak = torch.cuda.max_memory_allocated()
    print(f"  swap_images, batch {BATCH} of {RAW_SIZE}x{RAW_SIZE} frames: first {lat[0]:.3f} s, "
          f"steady {lat[1]:.3f} s, {BATCH / lat[1]:.3f} frames/s, peak {peak / 2**30:.2f} GiB; "
          f"launches K1 {launches['K1']} K2 {launches['K2']} K3 {launches['K3']} (as planned "
          f"by shape); output finite in [0,1], quad areas {[round(a, 1) for a in area.tolist()]} "
          f"px^2, changed {(out - target).abs().max().item():.3f} max", flush=True)
    stages, staged = raw_stages(pipe, target, source,
                                torch.Generator(device=dev).manual_seed(1))
    print("  the same request stage by stage (CUDA events, ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.2f}; max abs from the timed request "
          f"{(staged - out).abs().max().item():.3e}", flush=True)
    stats["swap_images"] = {"first_s": lat[0], "steady_s": lat[1], "frames_per_s": BATCH / lat[1],
                            "peak_gib": peak / 2**30, "launches": launches,
                            "stages_ms": stages}
    stats["bf16_vs_fp32"] = raw_bf16_vs_fp32(pipe, target)

    # swap_images_robust: two batches of 4 full-HD frames, state carried
    pipe.landmark_fn = template_landmarks
    frames = [raw_frames(40 + r, ROBUST_BATCH, *FRAME_HW) for r in range(2)]
    real = pipe.face_presence(frames[0])
    print(f"  face_presence of the first batch (random BiSeNet): {real.tolist()}; the robust "
          f"runs force {ROBUST_PRESENCE}", flush=True)
    src4 = source[:1].expand(ROBUST_BATCH, -1, -1, -1)
    ref224 = pipe._source_reference(src4)
    plan4 = mode_plan(cfg, cfg.ddim_steps, batch=ROBUST_BATCH)
    # one_program: LandmarkNet once a batch, on the swap-size crops
    lm4 = sum(landmark_norms(pipe.config.landmark, ROBUST_BATCH).values())
    pipe.swap_images_robust(frames[0], src4)  # warm-up at this batch and frame size
    stats["robust"] = {}
    for one_program in (True, False):
        state, times = None, []
        for r, presence in enumerate(ROBUST_PRESENCE):
            pipe.face_presence = lambda t, min_area_frac=2e-3, pr=presence: torch.tensor(pr)
            start_request()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, state, quads = pipe.swap_images_robust(
                frames[r], src4, generator=torch.Generator(device=dev).manual_seed(r),
                state=state, one_program=one_program, ref224=ref224 if r else None)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches = raw_request_launches(f"robust one_program={one_program} batch {r}",
                                            dict(plan4, K3=plan4["K3"] + lm4 * one_program))
            passthrough = [] if r else [0]
            check_raw_output(f"robust one_program={one_program} batch {r}", out, frames[r],
                             quads, passthrough)
            if state is None:
                fail(f"robust one_program={one_program} batch {r}: no state after a face")
        del pipe.face_presence
        stats["robust"][f"one_program={one_program}"] = {"s": times, "launches": launches}
        print(f"  swap_images_robust one_program={one_program}, 2 batches of {ROBUST_BATCH} "
              f"{FRAME_HW[0]}x{FRAME_HW[1]} frames (host landmarks, state carried, the second "
              f"with a precomputed ref224): {times[0]:.3f} s, {times[1]:.3f} s, "
              f"{ROBUST_BATCH * 2 / sum(times):.3f} frames/s; launches K1 {launches['K1']} K2 "
              f"{launches['K2']} K3 {launches['K3']} a batch (as planned); pass-through frame "
              f"unchanged, quads finite with area > 0", flush=True)
    pipe.landmark_fn = None
    stats["robust_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del pipe, swapper
    torch.cuda.empty_cache()
    stats["tiny_card_vs_cpu"] = raw_tiny_reference()
    return stats


# ------------------------------------------------------------------ phase 11

# The drivers at batch 1 (one pair a request), SwapConfig() at 512 px.
DRIVER_BATCH = 1
# within one level of 255: a driver's PNG against FaceSwapper.swap called
# directly; a flagged response against the blur of the unflagged one (the
# blur of a quantised image against the quantised blur, and the truncation)
LEVEL = 1.0 / 255.0
BLUR_LEVELS = 2.0 / 255.0
HF_CLIP_PREFIX = "cond_stage_model.model."


def batch_shapes(cfg: SwapConfig, batch: int):
    """K1 per UNet forward and K2 per swap at `batch`, (BH, N, M, D), from
    mode_plan(cfg, steps, batch)."""
    plan = mode_plan(cfg, cfg.ddim_steps, batch=batch)
    k1 = collections.Counter({(bh, n, n, d): c // plan["forwards"]
                              for (bh, n, d), c in plan["K1"].items() if c})
    return k1, plan["K2"]


def photo_like(seed: int, h: int, w: int):
    """(h, w, 3) uint8 with a photo's spectrum: a bicubic blow-up of coarse
    noise plus grain (random noise would make the codecs' worst case)."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((1, 3, h // 16 + 2, w // 16 + 2), generator=g)
    x = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)[0]
    x = x * 255 + torch.randn((3, h, w), generator=g) * 6
    return x.clamp(0, 255).to(torch.uint8).permute(1, 2, 0).contiguous().numpy()


def write_checkpoints(cpu_params: dict, d) -> dict:
    """Phase 3's towers as the reference's files, from seeded weights: a
    REFace last.ckpt (model.diffusion_model.*, first_stage_model.*, the
    conditioner's keys without the CLIP tower, LitEma's model_ema.*,
    global_step, optimizer_states, hyper_parameters), the CLIP tower as an
    HF CLIP file, a face-parsing BiSeNet file, and a diffusers-layout
    safety checker that flags nothing. Returns {name: path}."""
    f32 = lambda t: t.float() if t.is_floating_point() else t
    sd = {**{f"model.diffusion_model.{k}": f32(v) for k, v in cpu_params["unet"].items()},
          **{f"first_stage_model.{k}": f32(v) for k, v in cpu_params["vae"].items()},
          **{k: f32(v) for k, v in cpu_params["conditioner"].items()
             if not k.startswith(HF_CLIP_PREFIX)}}
    sd.update({"model_ema." + k.replace(".", ""): f32(v).clone()
               for k, v in cpu_params["unet"].items() if v.is_floating_point()})
    sd["model_ema.num_updates"] = torch.tensor(0, dtype=torch.int32)
    files = {"last.ckpt": {"state_dict": sd, "global_step": 0, "epoch": 0,
                           "optimizer_states": [{"state": {}, "param_groups": [{"lr": 1e-5}]}],
                           "hyper_parameters": {"scale_factor": 0.18215, "seed": 0}},
             "clip.pth": {k[len(HF_CLIP_PREFIX):]: f32(v)
                          for k, v in cpu_params["conditioner"].items()
                          if k.startswith(HF_CLIP_PREFIX)}}
    bisenet = BiSeNet(BiSeNetConfig(), device="cuda")
    init_params(bisenet, seed=5, dezero=True)
    files["79999_iter.pth"] = {k: f32(v.cpu()) for k, v in bisenet.state_dict().items()}
    safety = SafetyChecker(SafetyCheckerConfig(), device="cuda")
    init_params(safety, seed=6, dezero=True)
    g = torch.Generator().manual_seed(6)
    tower = {}
    for k, v in safety.state_dict().items():
        if k.startswith("tower.vision_model."):
            tower["vision_model.vision_model." + k[len("tower.vision_model."):]] = f32(v.cpu())
        elif k == "tower.visual_projection.weight":
            tower["visual_projection.weight"] = f32(v.cpu())
    embeds = {"concept_embeds": torch.randn(17, 768, generator=g),
              "special_care_embeds": torch.randn(3, 768, generator=g),
              "special_care_embeds_weights": torch.full((3,), 2.0)}
    # a cosine is at most 1: thresholds of 2 flag nothing (flag_everything
    # sets them to -2 once the file is read)
    files["safety_none.pth"] = {**tower, **embeds, "concept_embeds_weights": torch.full((17,), 2.0)}
    del bisenet, safety
    need = sum(t.numel() * t.element_size() for obj in (sd, files["clip.pth"], tower)
               for t in obj.values() if isinstance(t, torch.Tensor)) + 2 * 2**30
    free = shutil.disk_usage(d).free
    print(f"  free space under {d}: {free / 2**30:.1f} GiB, the files need about "
          f"{need / 2**30:.1f} GiB", flush=True)
    if free < 2 * need:
        fail(f"not enough free space for the checkpoint files: {free} < 2 x {need} bytes")
    paths = {}
    for name, obj in files.items():
        t0 = time.perf_counter()
        paths[name] = d / name
        torch.save(obj, paths[name])
        print(f"  wrote {name}: {paths[name].stat().st_size / 2**30:.3f} GiB in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    return paths


@contextlib.contextmanager
def flag_everything():
    """Inside the block, build_safety_checker gives the checker it reads
    with its 17 concept thresholds at -2: a cosine is at least -1, so it
    flags every image (the file is read as it stands; only the thresholds
    change, in memory)."""
    build = cli_common.build_safety_checker

    def build_flagging(*a, **kw):
        checker = build(*a, **kw)
        with torch.no_grad():
            checker.concept_embeds_weights.fill_(-2.0)
        return checker

    cli_common.build_safety_checker = build_flagging
    try:
        yield
    finally:
        cli_common.build_safety_checker = build


def driver_args(*argv):
    import argparse

    ap = argparse.ArgumentParser()
    cli_common.add_model_args(ap)
    ap.add_argument("--bisenet-ckpt", default=None)
    return ap.parse_args(list(argv))


def check_loaded(swapper, cpu_params: dict):
    """Every tensor of the loaded towers equal to phase 3's after the
    --weights-dtype cast (bfloat16: float32 entries rounded through it)."""
    bad = []
    for name, m in swapper.towers().items():
        for k, v in m.state_dict().items():
            want = cpu_params[name][k]
            if want.dtype == torch.float32:
                want = want.to(torch.bfloat16).float()
            if not torch.equal(v.cpu(), want.to(v.dtype)):
                bad.append(f"{name}.{k}")
    if bad:
        fail(f"the towers read from last.ckpt differ from phase 3's: {bad[:10]}")
    return sum(len(m.state_dict()) for m in swapper.towers().values())


def driver_launches(name, plan, requests: int):
    """The launches of a driver run of `requests` requests against the plan."""
    per_run = {"K1": collections.Counter({k: v * requests for k, v in plan["K1"].items()}),
               "K2": collections.Counter({k: v * requests for k, v in plan["K2"].items()}),
               "K3": plan["K3"] * requests}
    return raw_request_launches(name, per_run)


def geglu_erf(self, x):
    """FeedForwardGEGLU with SD's exact erf gelu (the port's is tanh)."""
    h, gate = torch.chunk(self.net[0].proj(x), 2, dim=-1)
    return self.net[2](h * F.gelu(gate))


def geglu_distance(swapper, cfg: SwapConfig) -> dict:
    """ROADMAP C1: one full-width UNet forward (bf16, and an fp32 copy with
    the same weights, where bf16's own rounding does not hide the form's
    effect) and one whole DDIM-50 request at batch 1 (bf16), each with the
    tanh gelu and with erf, on the same inputs and generator; the relative
    L2 of eps and of the image."""
    x9, t, ctx = unet_inputs(cfg, seed=13, ctx_batch=BATCH)
    req = make_request(60, cfg.image_size, "cuda", batch=DRIVER_BATCH)
    unet32 = fp32_copy(swapper.unet, UNetModel, dataclasses.replace(cfg.unet,
                                                                    dtype=torch.float32))
    runs = {}
    for form in ("tanh", "erf"):
        with contextlib.ExitStack() as stack:
            if form == "erf":
                stack.callback(setattr, FeedForwardGEGLU, "forward", FeedForwardGEGLU.forward)
                FeedForwardGEGLU.forward = geglu_erf
            with torch.inference_mode():
                eps = swapper.unet(x9, t, ctx).float()
                eps32 = unet32(x9, t, ctx)
            img = swapper.swap(**req, generator=torch.Generator(device="cuda").manual_seed(4))
            runs[form] = (eps, eps32, img)
    del unet32
    (e0, f0, i0), (e1, f1, i1) = runs["tanh"], runs["erf"]
    out = {"eps_rel_l2": errors(e1, e0)[1], "eps_max_abs": errors(e1, e0)[0],
           "eps_fp32_rel_l2": errors(f1, f0)[1], "eps_fp32_max_abs": errors(f1, f0)[0],
           "eps_bf16_vs_fp32_rel_l2": errors(e0, f0)[1],
           "image_rel_l2": errors(i1, i0)[1], "image_max_abs": errors(i1, i0)[0]}
    print(f"  GEGLU erf against tanh (ROADMAP C1), phase 3's weights: one UNet forward at "
          f"batch {BATCH}, eps rel L2 fp32 {out['eps_fp32_rel_l2']:.4e} (max abs "
          f"{out['eps_fp32_max_abs']:.4e}), bf16 {out['eps_rel_l2']:.4e} (max abs "
          f"{out['eps_max_abs']:.4e}; bf16 against fp32 with tanh: "
          f"{out['eps_bf16_vs_fp32_rel_l2']:.4e}); one DDIM-50 request at batch "
          f"{DRIVER_BATCH}, bf16, image rel L2 {out['image_rel_l2']:.4e} (max abs "
          f"{out['image_max_abs']:.4e})", flush=True)
    return out


def server_breakdown(ckpt: list, bisenet, safety, upload) -> dict:
    """Where a demo-server request's time goes: the server's steps called
    one by one on a pipeline built from the same files (ms, events around
    host work ending in a synchronise), the swap in the main thread and
    then in fresh threads, as ThreadingHTTPServer runs each request in a
    thread of its own."""
    import concurrent.futures

    import numpy as np

    args = driver_args(*ckpt, "--bisenet-ckpt", str(bisenet), "--seed", "9")
    pipe = cli_common.build_raw_pipeline(args, cli_common.build_swapper(args),
                                         RawPipelineConfig())
    checker = cli_common.build_safety_checker(str(safety), device="cuda")
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    src = timed("decode source", lambda: images.imdecode(upload[0]).astype(np.float32) / 255)
    tgt = timed("decode target", lambda: images.imdecode(upload[1]).astype(np.float32) / 255)
    swap = lambda: pipe.swap_images(tgt[None], src[None], generator=torch.Generator(
        device="cuda").manual_seed(9))[0].cpu().numpy()
    for name in ("swap, main thread", "swap, main thread again"):
        out01 = timed(name, swap)
    for i in range(2):
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
            ex.submit(timed, f"swap, fresh thread {i}", swap).result()
    out01 = timed("safety checker", lambda: checker(out01[None])[0][0].cpu().numpy())
    timed("PNG encode", lambda: images.imencode(
        ".png", np.clip(out01 * 255, 0, 255).astype(np.uint8)))
    print("  a server request's steps called one by one (ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()), flush=True)
    return ms


def codec_times(img) -> dict:
    """Host codec times at img's size (median of 5 calls, ms)."""
    png, jpg = images.imencode(".png", img), images.imencode(".jpg", img)
    runs = {"jpeg_decode": lambda: images.imdecode(jpg),
            "png_decode": lambda: images.imdecode(png),
            "png_encode": lambda: images.imencode(".png", img),
            "jpeg_encode": lambda: images.imencode(".jpg", img)}
    out = {}
    for name, fn in runs.items():
        fn()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = sorted(ts)[2]
    out["png_bytes"], out["jpeg_bytes"] = len(png), len(jpg)
    return out


def post_upload(port: int, source: bytes, target: bytes):
    """One multipart POST of two JPEG uploads; (status, body, seconds)."""
    import urllib.request

    boundary = "chipsmokeboundary"
    body = b""
    for name, data in (("source", source), ("target", target)):
        body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; "
                 f"filename=\"{name}.jpg\"\r\nContent-Type: image/jpeg\r\n\r\n").encode()
        body += data + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/process_images", data=body,
                                 headers={"Content-Type": f"multipart/form-data; "
                                                          f"boundary={boundary}"},
                                 method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        data = resp.read()
        return resp.status, resp.headers["Content-Type"], data, time.perf_counter() - t0


@contextlib.contextmanager
def serving(argv):
    """A demo server built from argv, serving on a thread until the block
    ends; yields its port."""
    import threading

    server = demo_server.make_server(argv)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=60)
        if th.is_alive():
            fail("the demo server's thread did not stop")


def drivers_path(cpu_params: dict, smi: str) -> dict:
    """Phase 11: the user entry points on phase 3's towers. Returns its
    stats; the launches of each driver run are held to mode_plan at batch 1
    (the counts set to 0 before each run and read after it)."""
    cfg = SwapConfig()
    plan = mode_plan(cfg, cfg.ddim_steps, batch=DRIVER_BATCH)
    # raw mode: LandmarkNet three times a request (target, source, the crop)
    raw_plan = dict(plan, K3=plan["K3"] + 3 * sum(
        landmark_norms(RawPipelineConfig().landmark, DRIVER_BATCH).values()))
    d = Path(__file__).resolve().parent / "build" / "chip_smoke_drivers"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    stats = {}
    try:
        # (a) the reference's files, written and read back at full width
        t0 = time.perf_counter()
        paths = write_checkpoints(cpu_params, d)
        stats["save_s"] = time.perf_counter() - t0
        ckpt = ["--ckpt", str(paths["last.ckpt"]), "--clip-ckpt", str(paths["clip.pth"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        swapper = cli_common.build_swapper(driver_args(*ckpt))
        torch.cuda.synchronize()
        stats["load_s"] = time.perf_counter() - t0
        n = check_loaded(swapper, cpu_params)
        sizes = {k: p.stat().st_size for k, p in paths.items()}
        stats["file_bytes"] = sizes
        print(f"  {smi}: wrote the files in {stats['save_s']:.2f} s; build_swapper(--ckpt "
              f"last.ckpt --clip-ckpt clip.pth) read {sizes['last.ckpt'] / 2**30:.3f} + "
              f"{sizes['clip.pth'] / 2**30:.3f} GiB onto the card in {stats['load_s']:.2f} s: "
              f"all {n} tensors bit-equal to phase 3's after the bfloat16 cast", flush=True)

        # (f) ROADMAP C1, on the towers just read
        stats["geglu"] = geglu_distance(swapper, cfg)

        # (b) cli.swap --precropped: one source, a PNG and a JPEG target
        src = photo_like(70, cfg.image_size, cfg.image_size)
        images.imwrite(d / "source.png", src)
        (d / "targets").mkdir()
        images.imwrite(d / "targets" / "t0.png", photo_like(71, cfg.image_size, cfg.image_size))
        images.imwrite(d / "targets" / "t1.jpg", photo_like(72, cfg.image_size, cfg.image_size))
        # FaceSwapper.swap called directly on the driver's first inputs and
        # generator state; then this swapper leaves the card, so that the
        # driver's peak holds its own swapper only
        src01 = cli_swap._read01(str(d / "source.png"))
        ref = clip_normalize(torch.from_numpy(src01[None]).cuda().permute(0, 3, 1, 2))
        tgt = cli_swap._read01(str(d / "targets" / "t0.png"), cfg.image_size)[None] * 2 - 1
        mask = cli_common.default_inpaint_mask(cfg.image_size)[None]
        direct = swapper.swap(target_image=tgt, inpaint_image=tgt * mask, inpaint_mask=mask,
                              ref_clip224=ref.permute(0, 2, 3, 1),
                              generator=torch.Generator(device="cuda").manual_seed(5))
        if not bool(torch.isfinite(direct).all()):
            fail("FaceSwapper.swap on the driver's inputs is not finite")
        want = ((direct[0].cpu() + 1) / 2).clamp(0, 1)
        del swapper, direct, ref
        torch.cuda.empty_cache()
        argv = ["--precropped", *ckpt, "--seed", "5", "--source", str(d / "source.png"),
                "--target", str(d / "targets"), "--outdir", str(d / "out")]
        start_request()  # the precropped driver's run starts here
        torch.cuda.reset_peak_memory_stats()
        done = cli_swap.main(argv)
        launches = driver_launches("cli.swap --precropped", plan, len(done))
        peak = torch.cuda.max_memory_allocated()
        outs = [images.imread(p) for p, _ in done]
        if [o.shape for o in outs] != [(cfg.image_size, cfg.image_size, 3)] * 2:
            fail(f"cli.swap --precropped wrote {[o.shape for o in outs]}")
        diff = (torch.from_numpy(outs[0]).float() / 255 - want).abs().max().item()
        print(f"  cli.swap --precropped (PNG and baseline-JPEG targets, {cfg.image_size} px, "
              f"DDIM-{cfg.ddim_steps}, batch {DRIVER_BATCH}): first {done[0][1]:.3f} s, steady "
              f"{done[1][1]:.3f} s (read, swap, write), peak {peak / 2**30:.2f} GiB; outputs "
              f"{[o.shape for o in outs]} read back by the port's decoder; the PNG within "
              f"{diff * 255:.3f} levels of FaceSwapper.swap called directly (limit 1); launches "
              f"K1 {launches['K1']} K2 {launches['K2']} K3 {launches['K3']} (as planned by "
              f"shape, {len(done)} requests)", flush=True)
        if diff > LEVEL + 1e-6:
            fail(f"cli.swap's output is {diff * 255:.3f} levels from FaceSwapper.swap")
        stats["cli_precropped"] = {"first_s": done[0][1], "steady_s": done[1][1],
                                   "peak_gib": peak / 2**30, "launches": launches,
                                   "levels_from_direct": diff * 255}
        torch.cuda.empty_cache()

        # (c) cli.swap raw mode: 1024 px JPEG targets, the BiSeNet file
        raw_src = photo_like(73, RAW_SIZE, RAW_SIZE)
        images.imwrite(d / "raw_source.png", raw_src)
        (d / "raw_targets").mkdir()
        for i in range(2):
            images.imwrite(d / "raw_targets" / f"f{i}.jpg", photo_like(74 + i, RAW_SIZE, RAW_SIZE))
        argv = [*ckpt, "--bisenet-ckpt", str(paths["79999_iter.pth"]), "--seed", "5",
                "--source", str(d / "raw_source.png"), "--target", str(d / "raw_targets"),
                "--outdir", str(d / "raw_out")]
        start_request()  # the raw driver's run starts here
        torch.cuda.reset_peak_memory_stats()
        done = cli_swap.main(argv)
        launches = driver_launches("cli.swap raw", raw_plan, len(done))
        peak = torch.cuda.max_memory_allocated()
        shapes = [images.imread(p).shape for p, _ in done]
        if shapes != [(RAW_SIZE, RAW_SIZE, 3)] * 2:
            fail(f"cli.swap raw wrote {shapes}")
        print(f"  cli.swap raw mode ({RAW_SIZE} px JPEG targets, --bisenet-ckpt): first "
              f"{done[0][1]:.3f} s, steady {done[1][1]:.3f} s, peak {peak / 2**30:.2f} GiB; "
              f"outputs {shapes}; launches K1 {launches['K1']} K2 {launches['K2']} K3 "
              f"{launches['K3']} (as planned)", flush=True)
        stats["cli_raw"] = {"first_s": done[0][1], "steady_s": done[1][1],
                            "peak_gib": peak / 2**30, "launches": launches}
        torch.cuda.empty_cache()

        # (d) the demo server, raw mode, three 1024 px JPEG uploads
        uploads = [(images.imencode(".jpg", photo_like(80 + 2 * i, RAW_SIZE, RAW_SIZE)),
                    images.imencode(".jpg", photo_like(81 + 2 * i, RAW_SIZE, RAW_SIZE)))
                   for i in range(3)]
        server = [*ckpt, "--bisenet-ckpt", str(paths["79999_iter.pth"]), "--seed", "9",
                  "--port", "0"]
        torch.cuda.reset_peak_memory_stats()
        lat, responses = [], []
        with serving([*server, "--safety-ckpt", str(paths["safety_none.pth"])]) as port:
            start_request()  # the server's run starts here
            for source, target in uploads:
                status, ctype, body, secs = post_upload(port, source, target)
                if status != 200 or ctype != "image/png":
                    fail(f"demo server answered {status} {ctype}: {body[:200]!r}")
                img = images.imdecode(body)
                if img.shape != (RAW_SIZE, RAW_SIZE, 3):
                    fail(f"demo server's PNG is {img.shape}")
                lat.append(secs)
                responses.append(img)
            launches = driver_launches("demo server", raw_plan, len(uploads))
        peak = torch.cuda.max_memory_allocated()
        print(f"  demo server (raw, --safety-ckpt that flags nothing): 3 multipart POSTs of "
              f"{RAW_SIZE} px JPEG pairs, status 200, PNGs of {responses[0].shape}; latency "
              f"first {lat[0]:.3f} s, steady {sum(lat[1:]) / 2:.3f} s; peak "
              f"{peak / 2**30:.2f} GiB; launches K1 {launches['K1']} K2 {launches['K2']} K3 "
              f"{launches['K3']} (as planned)", flush=True)
        with flag_everything(), serving([*server, "--safety-ckpt",
                                         str(paths["safety_none.pth"])]) as port:
            status, ctype, body, secs = post_upload(port, *uploads[0])
        if status != 200:
            fail(f"demo server with the flag-all checker answered {status}")
        flagged = torch.from_numpy(images.imdecode(body)).float() / 255
        plain = torch.from_numpy(responses[0]).float()[None].permute(0, 3, 1, 2) / 255
        blurred = SafetyChecker.blur(plain)[0].permute(1, 2, 0)
        blur_diff = (flagged - blurred).abs().max().item()
        moved = (flagged - plain[0].permute(1, 2, 0)).abs().mean().item()
        print(f"  the same first upload through a checker that flags every image: "
              f"{blur_diff * 255:.3f} levels from the blur of the unflagged response (limit "
              f"{BLUR_LEVELS * 255:.0f}), mean {moved * 255:.2f} levels from the unblurred",
              flush=True)
        if blur_diff > BLUR_LEVELS or moved * 255 < 1.0:
            fail("the flagged response is not the blur of the unflagged one")
        stats["demo_server"] = {"first_s": lat[0], "steady_s": sum(lat[1:]) / 2,
                                "peak_gib": peak / 2**30, "launches": launches,
                                "flagged_levels_from_blur": blur_diff * 255}
        torch.cuda.empty_cache()
        stats["demo_server"]["steps_ms"] = server_breakdown(
            ckpt, paths["79999_iter.pth"], paths["safety_none.pth"], uploads[1])
        torch.cuda.empty_cache()

        # (e) the host codecs at 1024 px
        stats["codecs_ms"] = codec_times(photo_like(90, RAW_SIZE, RAW_SIZE))
        c = stats["codecs_ms"]
        print(f"  {smi}: host codecs at {RAW_SIZE}x{RAW_SIZE} (median of 5, ms): JPEG decode "
              f"{c['jpeg_decode']:.2f}, PNG decode {c['png_decode']:.2f}, PNG encode "
              f"{c['png_encode']:.2f}, JPEG encode (q95) {c['jpeg_encode']:.2f}", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return stats


# ------------------------------------------------------------------ phase 12

# The reference's test bench (inference_test_bench.sh, evaluate_all.sh) at
# full width: 12 CelebA-style pairs at --n-samples 10, one full batch and a
# ragged tail of 2 padded to 10; an FFHQ-style tree at --n-samples 2.
BENCH_BATCH = 10
BENCH_PAIRS = 12
FFHQ_BATCH = 2
# the eval towers on the card against the CPU port, relative L2 of their
# outputs on EVAL_FILES of the swaps: the fp32 ResNet-50s (TF32 off) at
# fp32's summation-order distance, bf16 CLIP and IR-SE-50 at the distance
# phase 4 allows a bf16 tower from fp32 (TOWER_TOL)
EVAL_TOL = {"fp32": 1e-4, "bf16": 3e-2}
EVAL_FILES = 4


def mask19(size: int):
    """A CelebAMask-HQ-style 19-class mask (uint8): skin, brows, eyes, nose,
    mouth, lips, ears, hair above, neck below."""
    ys, xs = torch.meshgrid(torch.arange(size), torch.arange(size), indexing="ij")
    c, r = size // 2, size // 3
    m = torch.zeros(size, size, dtype=torch.uint8)
    m[(ys - c) ** 2 + (xs - c) ** 2 < r * r] = 1
    for label, (y0, y1, x0, x1) in {
            6: (-r // 2, -r // 3, -r // 2, -r // 6), 7: (-r // 2, -r // 3, r // 6, r // 2),
            4: (-r // 3, -r // 6, -r // 2, -r // 4), 5: (-r // 3, -r // 6, r // 4, r // 2),
            2: (-r // 8, r // 6, -r // 10, r // 10), 11: (r // 4, r // 3, -r // 4, r // 4),
            12: (r // 3, r // 2, -r // 4, r // 4), 10: (r // 4 + 2, r // 3, -r // 6, r // 6),
            8: (-r // 6, r // 6, -r - 8, -r + 4), 9: (-r // 6, r // 6, r - 4, r + 8)}.items():
        m[c + y0:c + y1, c + x0:c + x1] = label
    m[:c - r] = 13
    m[c + r:, c - r // 2:c + r // 2] = 17
    return m.numpy()


def write_test_bench(d) -> dict:
    """A CelebA-style tree (CelebA-HQ-img/{id}.jpg, baseline JPEGs at 1024
    px; CelebA-HQ-mask/Overall_mask/{id}.png at 512 px) of BENCH_PAIRS pairs
    and an FFHQ-style one (images512/, BiSeNet_mask/, 512 px PNGs) of
    FFHQ_BATCH, written by the port's encoders."""
    trees = {"celeba": TestBenchConfig(str(d / "celeba"), "celeba", num_pairs=BENCH_PAIRS),
             "ffhq": TestBenchConfig(str(d / "ffhq"), "ffhq", num_pairs=FFHQ_BATCH)}
    mask = mask19(512)
    for name, size in (("celeba", 1024), ("ffhq", 512)):
        cfg = trees[name]
        for k, i in enumerate(i for pair in cfg.pair_ids() for i in pair):
            for path, arr in ((cfg.img_path(i), photo_like(200 + k, size, size)),
                              (cfg.mask_path(i), mask)):
                Path(path).parent.mkdir(parents=True, exist_ok=True)
                images.imwrite(path, arr)
    return trees


def write_eval_towers(d) -> dict:
    """Seeded eval towers as the reference's files: an HF CLIPModel B/32 file
    (the vision tower with a text-side entry and logit_scale), Hopenet with
    its fc_finetune head, Deep3DFaceRecon's net_recon.backbone.* with the
    seven net_recon.final_layers.*, and ArcFace's IR-SE-50. Returns the
    cli.evaluate flags."""
    f32 = lambda sd: {k: v.float().cpu() if v.is_floating_point() else v.cpu()
                      for k, v in sd.items()}
    clip = CLIPVisionTower(CLIP_B32, device="cuda")
    hopenet = Hopenet(device="cuda")
    facerecon = FaceReconCoeffNet(device="cuda")
    arcface = IRSE50(ArcFaceConfig(), device="cuda")
    for seed, m in enumerate((clip, hopenet, facerecon, arcface)):
        init_params(m, seed=30 + seed)
    files = {
        "clip": {**f32(clip.state_dict()), "logit_scale": torch.tensor(4.6052),
                 "text_projection.weight": torch.zeros(512, 512)},
        "hopenet": {**f32(hopenet.state_dict()), "fc_finetune.weight": torch.zeros(66, 2048),
                    "fc_finetune.bias": torch.zeros(66)},
        "facerecon": {("net_recon." if k.startswith("final_layers.") else
                       "net_recon.backbone.") + k: v
                      for k, v in f32(facerecon.state_dict()).items()},
        "arcface": f32(arcface.state_dict()),
    }
    flags = []
    for name, sd in files.items():
        path = d / f"{name}.pth"
        torch.save(sd, path)
        flags += [f"--{name}-ckpt", str(path)]
    return flags


def bench_batches(ds, batch: int):
    """The driver's batches: in order, the ragged tail padded with its last
    item (cli.inference_test_bench)."""
    for lo in range(0, len(ds), batch):
        items = [ds[i] for i in range(lo, min(lo + batch, len(ds)))]
        yield collate(items + [items[-1]] * (batch - len(items)))


def eval_card_vs_cpu(flags: list, swaps: list, masks: list) -> dict:
    """Each eval tower read from its file on the card and on the CPU, their
    outputs on the first EVAL_FILES swaps (through the protocol's loaders),
    relative L2, held to EVAL_TOL."""
    ckpt = dict(zip(flags[0::2], flags[1::2]))
    paths = swaps[:EVAL_FILES]
    runs = {
        "fid": ("bf16", lambda m: clip_features(m, eval_protocol.clip_fid_load(paths))),
        "id": ("bf16", lambda m: eval_protocol.id_embed_protocol(
            m, eval_protocol.id_masked_112_load(paths, masks[:EVAL_FILES]))),
        "pose": ("fp32", lambda m: pose_angles(m, eval_protocol.hopenet_load(paths))),
        "expression": ("fp32", lambda m: expression_coeffs(m, eval_protocol.expression_load(paths))),
    }
    flag = {"fid": "--clip-ckpt", "id": "--arcface-ckpt", "pose": "--hopenet-ckpt",
            "expression": "--facerecon-ckpt"}
    out = {}
    for metric, (kind, fn) in runs.items():
        card, cpu = (torch.from_numpy(fn(cli_evaluate.build_tower(metric, ckpt[flag[metric]], dev)))
                     .double() for dev in ("cuda", "cpu"))
        rel = ((card - cpu).norm() / cpu.norm()).item()
        print(f"  {metric} tower ({kind}) on the card against the CPU port, {EVAL_FILES} "
              f"swaps: rel L2 {rel:.3e} (tol {EVAL_TOL[kind]:.0e}), max abs "
              f"{(card - cpu).abs().max().item():.3e}", flush=True)
        if not rel <= EVAL_TOL[kind]:
            fail(f"the {metric} tower on the card is {rel:.3e} from the CPU port")
        out[metric] = rel
    return out


def test_bench_path(cpu_params: dict, smi: str) -> dict:
    """Phase 12: cli.inference_test_bench and cli.evaluate on phase 3's towers
    at full width. Returns its stats; the launches of each driver run are
    held to mode_plan at its batch (the counts set to 0 before the run and
    read after it)."""
    cfg = SwapConfig()
    d = Path(__file__).resolve().parent / "build" / "chip_smoke_bench"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    stats = {}
    try:
        t0 = time.perf_counter()
        trees = write_test_bench(d)
        eval_flags = write_eval_towers(d)
        save_swap_params(d / "params.pt", cpu_params)
        ckpt = ["--ckpt", str(d / "params.pt")]
        stats["write_s"] = time.perf_counter() - t0
        print(f"  wrote {2 * BENCH_PAIRS} 1024 px JPEGs and their 512 px masks, "
              f"{2 * FFHQ_BATCH} 512 px PNG pairs, the four eval towers' files and the "
              f"towers' state dicts in {stats['write_s']:.2f} s", flush=True)

        # (a) FaceSwapper.swap called directly on the driver's batches (the
        # tail padded) with the driver's generator; then this swapper leaves
        # the card, so that the driver's peak holds its own swapper only
        swapper = cli_common.build_swapper(driver_args(*ckpt))
        ds = TestBenchDataset(dataclasses.replace(trees["celeba"], image_size=cfg.image_size))
        gen = torch.Generator(device="cuda").manual_seed(42)  # the driver's --seed
        direct = []
        for b in bench_batches(ds, BENCH_BATCH):
            out = swapper.swap(target_image=b["target_image"], inpaint_image=b["inpaint_image"],
                               inpaint_mask=b["inpaint_mask"], ref_clip224=b["ref_clip224"],
                               generator=gen)
            if not bool(torch.isfinite(out).all()):
                fail("FaceSwapper.swap on the test bench's batch is not finite")
            direct.append(((out.cpu() + 1) / 2).clamp(0, 1))
        direct = torch.cat(direct)[:len(ds)]
        del swapper, out
        torch.cuda.empty_cache()

        # (b) the driver: a warm-up run, then the timed one
        argv = [*ckpt, "--dataset-dir", trees["celeba"].dataset_dir, "--dataset", "celeba",
                "--n-samples", str(BENCH_BATCH), "--num-pairs", str(BENCH_PAIRS)]
        t0 = time.perf_counter()
        cli_test_bench.main([*argv, "--outdir", str(d / "warm")])
        warm_s = time.perf_counter() - t0
        start_request()  # the timed run starts here
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        times, loop_s = cli_test_bench.main([*argv, "--outdir", str(d / "out")])
        wall = time.perf_counter() - t0
        launches = driver_launches("cli.inference_test_bench celeba", mode_plan(
            cfg, cfg.ddim_steps, batch=BENCH_BATCH), len(times))
        peak = torch.cuda.max_memory_allocated()
        names = [f"{sid}_{tid}.png" for tid, sid in ds.pairs]
        got = sorted(p.name for p in (d / "out" / "results").iterdir())
        if got != sorted(names) or len(times) != 2:
            fail(f"cli.inference_test_bench wrote {got} in {len(times)} batches")
        outs = torch.stack([torch.from_numpy(images.imread(d / "out" / "results" / n))
                            for n in names]).float() / 255
        diff = (outs - direct).abs().max().item()
        print(f"  cli.inference_test_bench --n-samples {BENCH_BATCH} --num-pairs {BENCH_PAIRS} "
              f"(CelebA-style, 1024 px JPEGs, {cfg.image_size} px, DDIM-{cfg.ddim_steps}): "
              f"warm-up run {warm_s:.2f} s; timed run {wall:.2f} s, its loop {loop_s:.3f} s "
              f"(loader included): {BENCH_PAIRS / loop_s:.3f} swaps/s; batches "
              f"{', '.join(f'{t:.3f}' for t in times)} s (the second padded from 2; from the "
              f"loader's hand-over), {BENCH_PAIRS / sum(times):.3f} swaps/s over the batches, "
              f"{BENCH_BATCH / times[0]:.3f} swaps/s in the full one, peak {peak / 2**30:.2f} GiB; {len(got)} PNGs "
              f"{{sid}}_{{tid}}.png, within {diff * 255:.3f} levels of FaceSwapper.swap called "
              f"directly (limit 1); launches K1 {launches['K1']} K2 {launches['K2']} K3 "
              f"{launches['K3']} (as planned by shape, 2 batches of {BENCH_BATCH})", flush=True)
        if diff > LEVEL + 1e-6:
            fail(f"cli.inference_test_bench's output is {diff * 255:.3f} levels from "
                 "FaceSwapper.swap")
        stats["celeba"] = {"warm_s": warm_s, "wall_s": wall, "loop_s": loop_s, "batch_s": times,
                           "swaps_per_s": BENCH_PAIRS / loop_s,
                           "swaps_per_s_batches": BENCH_PAIRS / sum(times),
                           "swaps_per_s_full_batch": BENCH_BATCH / times[0],
                           "peak_gib": peak / 2**30, "launches": launches,
                           "levels_from_direct": diff * 255}
        torch.cuda.empty_cache()

        # (c) the FFHQ-style tree at --n-samples 2
        start_request()
        times, _ = cli_test_bench.main([*ckpt, "--dataset-dir", trees["ffhq"].dataset_dir,
                                     "--dataset", "ffhq", "--n-samples", str(FFHQ_BATCH),
                                     "--num-pairs", str(FFHQ_BATCH), "--outdir",
                                     str(d / "ffhq_out")])
        launches = driver_launches("cli.inference_test_bench ffhq", mode_plan(
            cfg, cfg.ddim_steps, batch=FFHQ_BATCH), len(times))
        got = sorted(p.name for p in (d / "ffhq_out" / "results").iterdir())
        want = sorted(f"{s}_{t}.png" for t, s in trees["ffhq"].pair_ids())
        if got != want:
            fail(f"cli.inference_test_bench (ffhq) wrote {got}, not {want}")
        print(f"  cli.inference_test_bench --dataset ffhq --n-samples {FFHQ_BATCH} (512 px "
              f"PNGs): batch {times[0]:.3f} s; {got}; launches K1 {launches['K1']} K2 "
              f"{launches['K2']} K3 {launches['K3']} (as planned)", flush=True)
        stats["ffhq"] = {"batch_s": times[0], "launches": launches}
        torch.cuda.empty_cache()

        # (d) cli.evaluate on the CelebA results: the four metrics, finite;
        # the eval towers launch none of the port's kernels
        start_request()
        args = cli_evaluate.parse_args(
            ["--results-dir", str(d / "out" / "results"), "--dataset-dir",
             trees["celeba"].dataset_dir, "--dataset", "celeba", "--metrics", "fid", "id",
             "pose", "expression", *eval_flags])
        t0 = time.perf_counter()
        metrics, seconds = cli_evaluate.run(args)
        eval_s = time.perf_counter() - t0
        raw_request_launches("cli.evaluate", {"K1": collections.Counter(),
                                              "K2": collections.Counter(), "K3": 0})
        if len(metrics) != 6 or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"cli.evaluate gave {metrics}")
        rates = {m: n / secs for m, (n, secs) in seconds.items()}
        print(f"  cli.evaluate --metrics fid id pose expression (towers read from the "
              f"reference-layout files) in {eval_s:.2f} s: {json.dumps(metrics)}; images/s "
              + ", ".join(f"{m} {r:.1f} ({seconds[m][0]} images)" for m, r in rates.items())
              + "; no kernel launched", flush=True)
        stats["evaluate"] = {"metrics": metrics, "wall_s": eval_s, "images_per_s": rates,
                             "images": {m: n for m, (n, _) in seconds.items()}}

        # (e) the towers on the card against the CPU port, on the same files
        swaps = [str(d / "out" / "results" / n) for n in names]
        masks = [trees["celeba"].mask_path(t) for t, _ in ds.pairs]
        stats["evaluate"]["card_vs_cpu_rel_l2"] = eval_card_vs_cpu(eval_flags, swaps, masks)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return stats


# ------------------------------------------------------------------ phase 14

# The gradient-guided swap (FaceSwapper.swap_guided) and the priors
# (cli.prepare_data make-priors) on phase 3's towers. The guided requests run
# DDIM-50 at batch 2; the drivers' guided runs (cli.swap --guidance) are cut
# to DDIM-10 (GUIDED_CLI_STEPS): they check the wiring, which the depth does
# not change.
ALL_TERMS = ("id", "seg", "exp")
GUIDED_CLI_STEPS = 10
PRIOR_PAIRS = 4
# a prior start's test bench at one batch of its pairs
PRIOR_BATCH = PRIOR_PAIRS
# the tiny fp32 guided swap, card against the CPU port (phase 5's limit)
GUIDED_TINY_TOL = 1e-3
# the BiSeNet classes whose region make-priors pastes (skin to lips: the face
# without hair, neck and cloth)
PRIOR_FACE = tuple(range(1, 13))
DEV = "cuda"


def guided_steps(cfg: SwapConfig, terms) -> int:
    """The steps of a request at which the guidance gradient is taken: the ID
    term's gate is open at 5 < t < 500; "seg" and "exp" at every step."""
    ts = DDIMTables.create(DiffusionSchedule.create(), cfg.ddim_steps, eta=cfg.eta,
                           method=cfg.ddim_discretize).timesteps.tolist()
    return len(ts) if set(terms) - {"id"} else sum(5 < t < 500 for t in ts)


def guided_plan(cfg: SwapConfig, terms, batch: int, extra_k2: int = 0) -> dict:
    """Launches of one guided request by wrapper and shape, from the config:
    the swap's K1, K2 and K3 (mode_plan: the UNet runs under no_grad, the
    encode and the final decode through K2; `extra_k2` more encodes), and at
    each guided step one decode under autograd through FlashAttention at the
    VAE's d=512 (its norms on the plain version): the residual forward, then
    one K4 and one K5 call (two launches) in the backward."""
    p = mode_plan(cfg, cfg.ddim_steps, batch=batch)
    n = cfg.latent_size**2
    wide = (batch, n, n, cfg.vae.ch * cfg.vae.ch_mult[-1])
    k2 = collections.Counter(p["K2"])
    k2[wide] += extra_k2
    steps = guided_steps(cfg, terms) if terms else 0
    flash = {wide: steps} if steps else {}
    k3 = p["K3 shapes"] + scaled(vae_norms(cfg.vae, batch, cfg.image_size)[0], extra_k2)
    nonzero = lambda c: {k: v for k, v in c.items() if v}
    return {"self_attention_smalld": nonzero(p["K1"]), "wide_attention": nonzero(k2),
            "group_norm_silu": nonzero(k3), "flash_attention_fwd": flash,
            "flash_bwd_dkv": flash, "flash_bwd_dq": flash}


@contextlib.contextmanager
def recorded_launches(out: dict):
    """Every wrapper's launches by shape inside the block, into `out`."""
    for k in KERNELS:
        k.shapes = collections.Counter()
    try:
        yield out
    finally:
        out.update({k.__name__: dict(k.shapes) for k in KERNELS})
        for k in KERNELS:
            k.shapes = None


def check_plan(name: str, got: dict, plan: dict) -> dict:
    """The launches by wrapper and shape against the plan; returns each
    wrapper's total."""
    if got != plan:
        bad = {k: (got.get(k), plan.get(k)) for k in plan if got.get(k) != plan.get(k)}
        fail(f"{name}: launches by shape (got, planned) {bad}")
    return {k: sum(v.values()) for k, v in got.items()}


def check_image(name: str, out, shape):
    if (tuple(out.shape) != tuple(shape) or not bool(torch.isfinite(out).all())
            or float(out.abs().max()) > 1.0):
        fail(f"{name}: output {tuple(out.shape)} not finite {shape} in [-1, 1]")


def write_guidance_towers(d: Path) -> dict:
    """Seeded fp32 BiSeNet (face-parsing's 79999_iter.pth keys), D3DFR
    (Deep3DFaceRecon's net_recon.backbone.* and net_recon.final_layers.*)
    and LandmarkNet files. Returns {name: path}."""
    f32 = lambda sd: {k: v.float().cpu() if v.is_floating_point() else v.cpu()
                      for k, v in sd.items()}
    towers = {"bisenet": init_params(BiSeNet(BiSeNetConfig(dtype=torch.float32), device=DEV),
                                     seed=9, dezero=True),
              "d3dfr": init_params(FaceReconCoeffNet(device=DEV), seed=10, dezero=True),
              "landmarks": init_params(LandmarkNet(LandmarkNetConfig(), device=DEV), seed=8)}
    files = {"bisenet": f32(towers["bisenet"].state_dict()),
             "d3dfr": {("net_recon." if k.startswith("final_layers.") else
                        "net_recon.backbone.") + k: v
                       for k, v in f32(towers["d3dfr"].state_dict()).items()},
             "landmarks": f32(towers["landmarks"].state_dict())}
    paths = {}
    for name, sd in files.items():
        paths[name] = d / f"{name}.pth"
        torch.save(sd, paths[name])
    return paths


def guided_request(swapper, r: int, terms, towers=(None, None), **kw):
    """One guided request of make_request(r) at batch 2: (output, seconds,
    launches by wrapper and shape)."""
    cfg = swapper.config
    req = make_request(r, cfg.image_size, DEV)
    got = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_launches(got):
        out = swapper.swap_guided(**req, generator=torch.Generator(device=DEV).manual_seed(r),
                                  guidance=terms, seg_logits_fn=towers[0],
                                  exp_coeff_fn=towers[1], **kw)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check_image(f"guided request {r} {terms}", out, (BATCH, cfg.image_size, cfg.image_size, 3))
    return out, secs, got


def id_loss_at(swapper, r: int):
    """The ID guidance term of swap_guided on make_request(r), as the guided
    sampler builds it, and a latent to take its gradient at."""
    from reface_tpu_torch.diffusion.guidance import combine_guidance, make_id_guidance

    cfg = swapper.config
    req = make_request(r, cfg.image_size, DEV)
    ref, mask = nchw(req["ref_clip224"]), nchw(req["inpaint_mask"])
    r3 = lambda a: torch.as_tensor(a, device=DEV).reshape(1, 3, 1, 1)
    src_pm1 = (ref * r3(CLIP_STD) + r3(CLIP_MEAN)) * 2.0 - 1.0
    decode = functools.partial(swapper.decode_latent, for_grad=True)
    loss_fn = combine_guidance(make_id_guidance(decode, swapper.embed_id, src_pm1,
                                                inpaint_region=1.0 - mask))
    g = torch.Generator(device=DEV).manual_seed(r)
    x = torch.randn((BATCH, 4, cfg.latent_size, cfg.latent_size), generator=g, device=DEV)
    return loss_fn, x


def loss_and_grad(loss_fn, x, t: int):
    xx = x.detach().requires_grad_(True)
    loss = loss_fn(xx, t)
    (g,) = torch.autograd.grad(loss, xx)
    return loss.detach().float(), g.float()


def guided_step_breakdown(swapper) -> dict:
    """One guided step's parts by CUDA events: the CFG eps (one dedup UNet
    forward under inference mode), the ID guidance gradient (decode under
    autograd, ArcFace, the backward), and inside it the decode's forward and
    its forward and backward alone."""
    cfg = swapper.config
    x9, t, ctx2 = unet_inputs(cfg, seed=7, ctx_batch=2 * BATCH)

    def eps():
        with torch.inference_mode():
            swapper.unet(x9, t, ctx2, cfg_expand=True)

    loss_fn, x = id_loss_at(swapper, 21)
    decode = functools.partial(swapper.decode_latent, for_grad=True)

    def dec_fwd():
        decode(x.detach().requires_grad_(True))

    def dec_fwd_bwd():
        xx = x.detach().requires_grad_(True)
        torch.autograd.grad(decode(xx).square().mean(), xx)

    out = {"eps_ms": time_ms(eps), "guidance_grad_ms": time_ms(lambda: loss_and_grad(loss_fn, x, 261)),
           "decode_fwd_ms": time_ms(dec_fwd), "decode_fwd_bwd_ms": time_ms(dec_fwd_bwd)}
    step = out["eps_ms"] + out["guidance_grad_ms"]
    out["decode_fwd_bwd_share"] = out["decode_fwd_bwd_ms"] / step
    out["decode_fwd_share"] = out["decode_fwd_ms"] / step
    print(f"  one guided step (batch {BATCH}) by CUDA events: CFG eps {out['eps_ms']:.2f} ms, "
          f"ID guidance gradient {out['guidance_grad_ms']:.2f} ms; the decode under autograd "
          f"{out['decode_fwd_ms']:.2f} ms forward, {out['decode_fwd_bwd_ms']:.2f} ms forward and "
          f"backward: {100 * out['decode_fwd_bwd_share']:.1f}% of the step "
          f"({100 * out['decode_fwd_share']:.1f}% its forward)", flush=True)
    return out


def guided_grad_vs_einsum(swapper, cpu_params: dict) -> dict:
    """One guided step's ID loss and latent gradient with the kernels (the
    decoder's mid-block through K2r, then K4 and K5) against the same step
    with the plain attention product (attn_impl="einsum"), in bf16 on the
    towers of the path and in fp32 on fp32 copies of them (the kernels'
    fp32 versions), each route also against the fp32 plain one. The fp32
    routes are held to phase 7's limits (TRAIN_TOL); in bf16 the kernels'
    route must be no further from the fp32 result than twice the plain
    route is."""
    cfg = swapper.config
    cfg32 = dataclasses.replace(
        cfg, vae=dataclasses.replace(cfg.vae, dtype=torch.float32),
        conditioner=dataclasses.replace(cfg.conditioner, arcface=dataclasses.replace(
            cfg.conditioner.arcface, dtype=torch.float32)))
    fp32 = FaceSwapper(cfg32, cpu_params, device=DEV)
    n = cfg.latent_size**2
    wide = {(BATCH, n, n, cfg.vae.ch * cfg.vae.ch_mult[-1]): 1}
    out, res = {}, {}
    for kind, sw in (("bf16", swapper), ("fp32", fp32)):
        loss_fn, x = id_loss_at(sw, 22)
        got = {}
        with recorded_launches(got):
            res[kind, "kernels"] = loss_and_grad(loss_fn, x, 261)
            torch.cuda.synchronize()
        check_plan(f"one guided gradient ({kind})", got, {
            "self_attention_smalld": {}, "wide_attention": {}, "group_norm_silu": {},
            "flash_attention_fwd": wide, "flash_bwd_dkv": wide, "flash_bwd_dq": wide})
        attn = sw.vae.decoder.mid.attn_1
        attn.attn_impl = "einsum"
        try:
            res[kind, "einsum"] = loss_and_grad(loss_fn, x, 261)
        finally:
            attn.attn_impl = "auto"
        if kind == "fp32":
            with torch.no_grad():
                img = sw.decode_latent(x)
            out["clamped_share"] = (img.abs() >= 1.0).float().mean().item()
    del fp32
    torch.cuda.empty_cache()
    ref_l, ref_g = res["fp32", "einsum"]
    for key, (l, g) in res.items():
        out["/".join(key)] = {"loss": l.item(), "loss_rel": ((l - ref_l).abs() / ref_l.abs()).item(),
                              "grad_rel_l2": ((g - ref_g).norm() / ref_g.norm()).item()}
    (l16, g16), (l16e, g16e) = res["bf16", "kernels"], res["bf16", "einsum"]
    out["bf16 kernels vs bf16 einsum"] = {
        "loss_rel": ((l16 - l16e).abs() / l16e.abs()).item(),
        "grad_rel_l2": ((g16 - g16e).norm() / g16e.norm()).item()}
    print(f"  one guided step's ID loss and latent gradient (t = 261, batch {BATCH}; "
          f"{100 * out['clamped_share']:.1f}% of the decoded pixels on the clamp), against the "
          f"fp32 towers' plain route (|grad| {ref_g.norm().item():.3e}): "
          + "; ".join(f"{k} loss rel {v['loss_rel']:.3e}, grad rel L2 {v['grad_rel_l2']:.3e}"
                      for k, v in out.items() if isinstance(v, dict)), flush=True)
    f32 = out["fp32/kernels"]
    if not (f32["loss_rel"] <= TRAIN_TOL["loss"] and f32["grad_rel_l2"] <= TRAIN_TOL["grad"]):
        fail("the fp32 guided gradient through the kernels disagrees with the einsum route")
    if not out["bf16/kernels"]["grad_rel_l2"] <= 2 * out["bf16/einsum"]["grad_rel_l2"]:
        fail("the bf16 guided gradient through the kernels is further from fp32 than the "
             "einsum route's allows")
    return out


def guided_tiny_reference(paths: dict) -> dict:
    """tiny_swap_config at 256 px with phase 5's VAE (mid-block 512 wide: the
    decode under autograd reaches K2r, K4 and K5 at 1024 tokens), 4 DDIM
    steps (the ID gate open at t = 251), fp32, all three terms with the fp32
    BiSeNet and D3DFR files: the card against the port on the CPU, x_T
    fixed, no random draw."""
    import argparse

    base = tiny_swap_config(image_size=256, ddim_steps=4)
    cfg = dataclasses.replace(base, sample_posterior=False,
                              vae=dataclasses.replace(base.vae, ch=32, ch_mult=(1, 2, 4, 16)))
    card = FaceSwapper(cfg, device=DEV)
    for i, m in enumerate(card.towers().values()):
        init_params(m, seed=40 + i, dezero=True)
    cpu = FaceSwapper(cfg, device="cpu")
    cpu.load_params({name: {k: v.cpu() for k, v in m.state_dict().items()}
                     for name, m in card.towers().items()})
    args = argparse.Namespace(bisenet_ckpt=str(paths["bisenet"]), d3dfr_ckpt=str(paths["d3dfr"]))
    req = make_request(6, 256, "cpu")
    req["x_T"] = torch.randn((BATCH, 32, 32, 4), generator=torch.Generator().manual_seed(6))
    outs, secs = {}, {}
    for name, sw in (("card", card), ("cpu", cpu)):
        seg_fn, exp_fn = cli_swap.guidance_towers(args, ALL_TERMS, sw.device)
        reset_counts()
        t0 = time.perf_counter()
        outs[name] = sw.swap_guided(**{k: v.to(sw.device) for k, v in req.items()},
                                    guidance=ALL_TERMS, seg_logits_fn=seg_fn,
                                    exp_coeff_fn=exp_fn).cpu()
        secs[name] = time.perf_counter() - t0
        if name == "card":
            launched = counts()
    unguided = cpu.swap(**req)
    err = (outs["card"] - outs["cpu"]).abs().max().item()
    moved = (outs["cpu"] - unguided).abs().max().item()
    print(f"  tiny 256 px guided swap (id, seg, exp; 4 steps), card vs CPU: max abs err "
          f"{err:.3e} (tol {GUIDED_TINY_TOL:.0e}); {moved:.3f} from the unguided swap; card "
          f"{secs['card']:.2f} s, CPU {secs['cpu']:.2f} s; launches (K1, K2, K3, K2r, K4, "
          f"K5) {launched}", flush=True)
    if min(launched[:2]) == 0 or min(launched[3:]) == 0:
        fail("the tiny guided run did not reach K1, K2, K2r, K4 and K5")
    if not err <= GUIDED_TINY_TOL or not moved > 1e-3:
        fail("the card's tiny guided swap disagrees with the CPU port, or did not move")
    return {"max_abs_err": err, "moved_from_unguided": moved, "launches": launched}


def dift_agreement(swapper, cpu_params: dict, target, source) -> float:
    """The share of DIFT lattice cells (grid 128) whose source index is the
    same with the swap towers' bf16 features as with an fp32 copy's."""
    from reface_tpu_torch.preprocess.priors import dift_index, make_unet_feats_fn

    cfg = swapper.config
    cfg32 = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dtype=torch.float32),
                                vae=dataclasses.replace(cfg.vae, dtype=torch.float32))
    fp32 = FaceSwapper(cfg32, {k: cpu_params[k] for k in ("unet", "vae", "conditioner")},
                       device=DEV)
    idx = {}
    for name, sw in (("bf16", swapper), ("fp32", fp32)):
        feats = make_unet_feats_fn(sw)
        idx[name] = dift_index(feats(target), feats(source), 128)
    del fp32
    torch.cuda.empty_cache()
    return (idx["bf16"] == idx["fp32"]).float().mean().item()


def write_prior_tree(d: Path) -> dict:
    """A CelebA-style test bench of PRIOR_PAIRS pairs (1024 px baseline
    JPEGs, 512 px 19-class masks) and make-priors' directories: targets/ and
    sources/ (each pair's images at 512 px as PNGs under the target's id, so
    that the i-th sorted of each pair up) and masks/ (white on PRIOR_FACE)."""
    tb = TestBenchConfig(str(d / "celeba"), "celeba", num_pairs=PRIOR_PAIRS)
    m19 = mask19(512)
    for sub in ("targets", "sources", "masks"):
        (d / sub).mkdir()
    for k, (tid, sid) in enumerate(tb.pair_ids()):
        for j, i in enumerate((tid, sid)):
            for path, arr in ((tb.img_path(i), photo_like(400 + 2 * k + j, 1024, 1024)),
                              (tb.mask_path(i), m19)):
                Path(path).parent.mkdir(parents=True, exist_ok=True)
                images.imwrite(path, arr)
        for sub, i in (("targets", tid), ("sources", sid)):
            images.imwrite(d / sub / f"{tid}.png",
                           images.resize_linear(images.imread(tb.img_path(i)), 512, 512))
        images.imwrite(d / "masks" / f"{tid}.png",
                       (torch.isin(torch.from_numpy(m19), torch.tensor(PRIOR_FACE)).numpy()
                        * 255).astype("uint8"))
    return {"bench": tb}


def guidance_determinism(swapper, towers) -> dict:
    """ROADMAP C1's probe, one guided step's gradient per term (id, seg,
    exp; t = 261): what torch.use_deterministic_algorithms(True,
    warn_only=True) flags on its path, and whether three gradients, taken
    as the guided sampler takes them (cuDNN's deterministic algorithms for
    this gradient alone), are bit-equal."""
    import warnings

    from reface_tpu_torch.diffusion.ddim_guided import deterministic_cudnn
    from reface_tpu_torch.diffusion.guidance import (
        combine_guidance,
        make_expression_guidance,
        make_id_guidance,
        make_seg_guidance,
    )

    cfg = swapper.config
    req = make_request(22, cfg.image_size, DEV)
    target, ref, mask = (nchw(req[k]) for k in ("target_image", "ref_clip224", "inpaint_mask"))
    decode = functools.partial(swapper.decode_latent, for_grad=True)
    r3 = lambda a: torch.as_tensor(a, device=DEV).reshape(1, 3, 1, 1)
    terms = {
        "id": make_id_guidance(decode, swapper.embed_id,
                               (ref * r3(CLIP_STD) + r3(CLIP_MEAN)) * 2.0 - 1.0,
                               inpaint_region=1.0 - mask),
        "seg": make_seg_guidance(decode, towers[0], target),
        "exp": make_expression_guidance(decode, towers[1], target, inpaint_region=1.0 - mask)}
    g = torch.Generator(device=DEV).manual_seed(22)
    x = torch.randn((BATCH, 4, cfg.latent_size, cfg.latent_size), generator=g, device=DEV)
    out = {}
    for name, term in terms.items():
        loss_fn = combine_guidance(term)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with deterministic_cudnn():
                    loss_and_grad(loss_fn, x, 261)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        flags = sorted({str(w.message).splitlines()[0][:200] for w in caught})
        with deterministic_cudnn():
            grads = [loss_and_grad(loss_fn, x, 261)[1] for _ in range(3)]
        same = all(torch.equal(grads[0], gi) for gi in grads[1:])
        out[name] = {"flagged": flags, "grads_bit_equal": same}
        print(f"  C1 probe, one guided step's gradient ({name}): use_deterministic_algorithms "
              f"flags {flags or 'nothing'}; three gradients bit-equal {same}", flush=True)
        if not same:
            fail(f"the {name} guidance gradient is not reproducible (ROADMAP C1)")
    return out


def guided_path(cpu_params: dict, smi: str, gen) -> dict:
    """Phase 14: the gradient-guided swap and the priors on phase 3's towers.
    Returns its stats; each run's launches are held by wrapper and shape to
    the plan from the config (every count set to 0 before the run)."""
    cfg = SwapConfig()
    d = Path(__file__).resolve().parent / "build" / "chip_smoke_guided"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    stats = {}
    try:
        paths = write_guidance_towers(d)
        save_swap_params(d / "params.pt", cpu_params)
        ckpt = ["--ckpt", str(d / "params.pt")]
        swapper = FaceSwapper(cfg, cpu_params, device=DEV)

        # (a) the ID-guided request: one warm-up, one timed
        plan = guided_plan(cfg, ("id",), BATCH)
        lat, outs = [], []
        for r in (10, 11, 11):  # a warm-up, then one request twice with the same seed
            reset_counts()  # the guided path's run starts here
            torch.cuda.reset_peak_memory_stats()
            out, secs, got = guided_request(swapper, r, ("id",))
            launches = check_plan(f"guided request {r}", got, plan)
            lat.append(secs)
            outs.append(out)
        peak = torch.cuda.max_memory_allocated()
        n_id = guided_steps(cfg, ("id",))
        same = torch.equal(outs[1], outs[2])
        print(f"  {smi}: swap_guided(guidance=('id',)), batch {BATCH}, DDIM-{cfg.ddim_steps}, "
              f"CFG {cfg.cfg_scale}: first {lat[0]:.3f} s, timed {lat[1]:.3f} s and "
              f"{lat[2]:.3f} s, peak {peak / 2**30:.2f} GiB; the two timed requests (one seed) "
              f"bit-equal {same} (max abs {(outs[1] - outs[2]).abs().max().item():.3e}); "
              f"launches {launches} (as planned by shape: the gradient at the {n_id} steps with "
              f"5 < t < 500)", flush=True)
        if not same:
            fail("two ID-guided requests with the same seed differ (ROADMAP C1)")
        stats["id"] = {"first_s": lat[0], "timed_s": lat[1], "again_s": lat[2],
                       "peak_gib": peak / 2**30, "launches": launches, "guided_steps": n_id,
                       "same_seed_bit_equal": same}
        del outs
        stats["step"] = guided_step_breakdown(swapper)

        # (b) guidance scale 0 against FaceSwapper.swap on the same draws
        req = make_request(30, cfg.image_size, DEV)
        a = swapper.swap_guided(**req, generator=torch.Generator(device=DEV).manual_seed(30),
                                guidance_scale=0.0)
        b = swapper.swap(**req, generator=torch.Generator(device=DEV).manual_seed(30))
        same = torch.equal(a, b)
        err = (a - b).abs().max().item()
        print(f"  swap_guided at guidance_scale=0 against FaceSwapper.swap, the same generator: "
              f"bit-equal {same} (max abs {err:.3e}; else limit {GUIDED_TINY_TOL:.0e})",
              flush=True)
        if not (same or err <= GUIDED_TINY_TOL):
            fail("swap_guided at scale 0 differs from FaceSwapper.swap")
        stats["scale0_bit_equal"] = same
        del a, b

        # (c) one guided step's gradient, kernels against einsum
        stats["grad_vs_einsum"] = guided_grad_vs_einsum(swapper, cpu_params)

        # (d) all three terms, one decode a step: the gradient at all 50 steps
        args = argparse.Namespace(bisenet_ckpt=str(paths["bisenet"]),
                                  d3dfr_ckpt=str(paths["d3dfr"]))
        towers = cli_swap.guidance_towers(args, ALL_TERMS, torch.device(DEV))
        out3, secs3 = [], []
        for _ in range(2):  # the same request twice
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            o, sec, got = guided_request(swapper, 12, ALL_TERMS, towers)
            launches3 = check_plan("guided request (id, seg, exp)", got,
                                   guided_plan(cfg, ALL_TERMS, BATCH))
            out3.append(o)
            secs3.append(sec)
        peak3 = torch.cuda.max_memory_allocated()
        same3 = torch.equal(out3[0], out3[1])
        print(f"  swap_guided(guidance=('id', 'seg', 'exp')) with fp32 BiSeNet (256 px) and "
              f"D3DFR (224 px), batch {BATCH}: {secs3[0]:.3f} s (first call of both towers), "
              f"{secs3[1]:.3f} s again with the same seed, bit-equal {same3}; peak "
              f"{peak3 / 2**30:.2f} GiB; launches {launches3} (as planned: one decode a step at "
              f"all {cfg.ddim_steps} steps)", flush=True)
        if not same3:
            fail("two id, seg, exp guided requests with the same seed differ (ROADMAP C1)")
        stats["id_seg_exp"] = {"s": secs3[0], "again_s": secs3[1], "peak_gib": peak3 / 2**30,
                               "launches": launches3, "same_seed_bit_equal": same3}
        stats["determinism"] = guidance_determinism(swapper, towers)
        del out3, towers

        # (e) DIFT's correspondence, bf16 against fp32 features, on one pair
        tree = write_prior_tree(d)
        pm1 = lambda p: torch.from_numpy(images.imread(p).astype("float32") / 127.5 - 1.0).to(DEV)
        tid = tree["bench"].pair_ids()[0][0]
        share = dift_agreement(swapper, cpu_params, pm1(d / "targets" / f"{tid}.png"),
                               pm1(d / "sources" / f"{tid}.png"))
        print(f"  DIFT lattice cells (grid 128, one pair) whose source cell is the same with "
              f"bf16 as with fp32 features: {100 * share:.2f}%", flush=True)
        stats["dift_index_agreement_bf16_fp32"] = share
        del swapper
        torch.cuda.empty_cache()

        # (f) the tiny fp32 guided swap, card against CPU
        stats["tiny"] = guided_tiny_reference(paths)
        torch.cuda.empty_cache()

        # (g) cli.swap --guidance id,seg,exp, --precropped and raw, at
        # DDIM-GUIDED_CLI_STEPS, each within one level of its direct call
        flags = [*ckpt, "--seed", "5", "--ddim-steps", str(GUIDED_CLI_STEPS), "--guidance",
                 ",".join(ALL_TERMS), "--bisenet-ckpt", str(paths["bisenet"]),
                 "--d3dfr-ckpt", str(paths["d3dfr"])]
        cfg10 = dataclasses.replace(cfg, ddim_steps=GUIDED_CLI_STEPS)
        images.imwrite(d / "source.png", photo_like(91, cfg.image_size, cfg.image_size))
        images.imwrite(d / "target.png", photo_like(92, cfg.image_size, cfg.image_size))
        images.imwrite(d / "raw_source.png", photo_like(93, RAW_SIZE, RAW_SIZE))
        images.imwrite(d / "raw_target.png", photo_like(94, RAW_SIZE, RAW_SIZE))
        for mode, (src, tgt) in (("precropped", ("source.png", "target.png")),
                                 ("raw", ("raw_source.png", "raw_target.png"))):
            argv = ["--source", str(d / src), "--target", str(d / tgt), "--outdir",
                    str(d / mode), *flags] + (["--precropped"] if mode == "precropped" else [])
            args = cli_swap.build_parser().parse_args(argv)
            sw = cli_common.build_swapper(args)
            cli_swap.use_guidance(args, ALL_TERMS, sw)
            if mode == "precropped":
                src01 = cli_swap._read01(str(d / src))
                ref = clip_normalize(torch.from_numpy(src01[None]).to(DEV).permute(0, 3, 1, 2))
                t = cli_swap._read01(str(d / tgt), cfg.image_size)[None] * 2 - 1
                mask = cli_common.default_inpaint_mask(cfg.image_size)[None]

                def direct(g):
                    out = sw.swap(target_image=t, inpaint_image=t * mask, inpaint_mask=mask,
                                  ref_clip224=ref.permute(0, 2, 3, 1), generator=g)[0]
                    return ((out.cpu() + 1) / 2).clamp(0, 1)
            else:
                pipe = cli_common.build_raw_pipeline(args, sw, RawPipelineConfig())

                def direct(g):
                    return pipe.swap_images(cli_swap._read01(str(d / tgt))[None],
                                            cli_swap._read01(str(d / src))[None],
                                            generator=g)[0].cpu().clamp(0, 1)
            want = direct(torch.Generator(device=DEV).manual_seed(5))
            del sw, direct
            if mode == "raw":
                del pipe
            torch.cuda.empty_cache()
            files, secs = [], []
            for run in range(2):  # twice, the same seed
                reset_counts()
                torch.cuda.reset_peak_memory_stats()
                got = {}
                with recorded_launches(got):
                    done = cli_swap.main(argv)
                plan = guided_plan(cfg10, ALL_TERMS, 1)
                if mode == "raw":  # LandmarkNet on the target, the source and the crop
                    plan["group_norm_silu"] = dict(collections.Counter(plan["group_norm_silu"])
                                                   + scaled(landmark_norms(
                                                       RawPipelineConfig().landmark, 1), 3))
                launches = check_plan(f"cli.swap --guidance ({mode})", got, plan)
                files.append(images.imread(done[0][0]))
                secs.append(done[0][1])
            peak = torch.cuda.max_memory_allocated()
            same = bool((files[0] == files[1]).all())
            img = torch.from_numpy(files[0]).float() / 255
            diff = (img - want).abs().max().item()
            print(f"  cli.swap --guidance id,seg,exp ({mode}, DDIM-{GUIDED_CLI_STEPS}, batch 1): "
                  f"{secs[0]:.3f} s and {secs[1]:.3f} s, the two files bit-equal {same}; peak "
                  f"{peak / 2**30:.2f} GiB, {tuple(img.shape)} within {diff * 255:.3f} levels of "
                  f"the direct call (limit 1); launches {launches} (as planned)", flush=True)
            if not same:
                fail(f"two cli.swap --guidance ({mode}) runs with the same seed differ (C1)")
            if diff > LEVEL + 1e-6:
                fail(f"cli.swap --guidance ({mode}) is {diff * 255:.3f} levels from the direct call")
            stats[f"cli_{mode}"] = {"s": secs[0], "again_s": secs[1], "peak_gib": peak / 2**30,
                                    "levels_from_direct": diff * 255, "same_seed_bit_equal": same,
                                    "launches": launches}

        # (h) make-priors, both methods, on PRIOR_PAIRS pairs at 512 px
        prior_flags = ["make-priors", "--target-dir", str(d / "targets"), "--source-dir",
                       str(d / "sources"), "--mask-dir", str(d / "masks")]
        k1_fwd = mode_plan(dataclasses.replace(cfg, cfg_scale=1.0), 1, batch=1)["K1"]
        n = cfg.latent_size**2
        feats_per_pair = 2 * 4  # two images, an ensemble of 4 forwards each
        # K3: tps, LandmarkNet on each image; dift, each image's encode and
        # its 4 UNet forwards at batch 1
        dift_k3 = scaled(vae_norms(cfg.vae, 1, cfg.image_size)[0], 2 * PRIOR_PAIRS) + scaled(
            unet_norms(cfg.unet, 1, cfg.latent_size), feats_per_pair * PRIOR_PAIRS)
        prior_plans = {
            "tps": {**{k.__name__: {} for k in KERNELS}, "group_norm_silu": dict(
                scaled(landmark_norms(LandmarkNetConfig(), 1), 2 * PRIOR_PAIRS))},
            "dift": {"self_attention_smalld": {k: feats_per_pair * PRIOR_PAIRS * c
                                               for k, c in k1_fwd.items() if c},
                     "wide_attention": {(1, n, n, cfg.vae.ch * cfg.vae.ch_mult[-1]):
                                        2 * PRIOR_PAIRS},
                     "group_norm_silu": dict(dift_k3), "flash_attention_fwd": {},
                     "flash_bwd_dkv": {}, "flash_bwd_dq": {}}}
        extra = {"tps": ["--landmark-ckpt", str(paths["landmarks"])], "dift": ckpt}
        for method in ("tps", "dift"):
            reset_counts()
            got = {}
            with recorded_launches(got):
                done = cli_prepare.main([*prior_flags, "--out-dir", str(d / f"priors_{method}"),
                                         "--method", method, *extra[method]])
            launches = check_plan(f"make-priors --method {method}", got, prior_plans[method])
            worst_out, worst_in = 0, 255
            for (path, _), (tid, _) in zip(done, tree["bench"].pair_ids()):
                prior = torch.from_numpy(images.imread(path)).int()
                tgt = torch.from_numpy(images.imread(d / "targets" / f"{tid}.png")).int()
                face = torch.from_numpy(images.imread(d / "masks" / f"{tid}.png", gray=True)) > 127
                worst_out = max(worst_out, (prior - tgt).abs()[~face].max().item())
                worst_in = min(worst_in, (prior - tgt).abs()[face].float().mean().item())
            secs = [s for _, s in done]
            print(f"  make-priors --method {method} ({PRIOR_PAIRS} pairs, 512 px): "
                  f"{len(done)} files, seconds a pair {', '.join(f'{s:.3f}' for s in secs)}; "
                  f"outside the mask within {worst_out} levels of the target (limit 1), inside "
                  f"it {worst_in:.1f} levels from it on average; launches {launches} (as "
                  f"planned)", flush=True)
            if len(done) != PRIOR_PAIRS or worst_out > 1 or not worst_in > 1:
                fail(f"make-priors --method {method}: its files do not hold the prior")
            stats[f"priors_{method}"] = {"s_per_pair": secs, "launches": launches}

        # (i) the test bench's prior start on the DIFT priors
        tb = dataclasses.replace(tree["bench"], image_size=cfg.image_size,
                                 prior_dir=str(d / "priors_dift"))
        sw = cli_common.build_swapper(driver_args(*ckpt))
        ds = TestBenchDataset(tb)
        batch = collate([ds[i] for i in range(len(ds))])
        direct = sw.swap(target_image=batch["target_image"], inpaint_image=batch["inpaint_image"],
                         inpaint_mask=batch["inpaint_mask"], ref_clip224=batch["ref_clip224"],
                         generator=torch.Generator(device=DEV).manual_seed(42),
                         prior_image=batch["prior_image"])
        direct = ((direct.cpu() + 1) / 2).clamp(0, 1)
        del sw
        torch.cuda.empty_cache()
        reset_counts()
        got = {}
        with recorded_launches(got):
            times, _ = cli_test_bench.main([*ckpt, "--dataset-dir", tb.dataset_dir, "--dataset",
                                            "celeba", "--n-samples", str(PRIOR_BATCH),
                                            "--num-pairs", str(PRIOR_PAIRS), "--prior-dir",
                                            tb.prior_dir, "--outdir", str(d / "bench")])
        launches = check_plan("inference_test_bench --prior-dir", got,
                              guided_plan(cfg, (), PRIOR_BATCH, extra_k2=1))
        outs = torch.stack([torch.from_numpy(images.imread(
            d / "bench" / "results" / f"{sid}_{tid}.png")) for tid, sid in ds.pairs]).float() / 255
        diff = (outs - direct).abs().max().item()
        print(f"  cli.inference_test_bench --prior-dir (the DIFT priors) --n-samples "
              f"{PRIOR_BATCH}: batch {times[0]:.3f} s; {len(outs)} PNGs within "
              f"{diff * 255:.3f} levels of FaceSwapper.swap(prior_image=...) (limit 1); "
              f"launches {launches} (as planned: K2 also encodes the prior)", flush=True)
        if diff > LEVEL + 1e-6:
            fail(f"the prior-start test bench is {diff * 255:.3f} levels from FaceSwapper.swap")
        stats["prior_bench"] = {"batch_s": times[0], "levels_from_direct": diff * 255,
                                "launches": launches}
    finally:
        shutil.rmtree(d, ignore_errors=True)

    # (j) K2r, K4 and K5 at the guided decode's shape against their plain
    # versions, timed beside their bounds and sdpa
    shape = (BATCH, cfg.latent_size**2, cfg.latent_size**2, cfg.vae.ch * cfg.vae.ch_mult[-1])
    print(f"  K2r, K4 and K5 at the guided decode's shape (BH,N,M,D)={shape}", flush=True)
    stats["kernels_worst"] = check_train_kernels(gen, [shape])
    stats["kernels"] = {k: v[shape] for k, v in time_train_kernels(gen, [shape]).items()}
    return stats


# ------------------------------------------------------------------ phase 6

def check_workspaces(workspaces, q, k, v, lse, do, di, scale):
    """The dS and P workspaces that bf16 K5's call writes at d > 128 (and
    K4's GEMM reads) against flash_bwd_ds_plain (dS and P rounded to bf16
    as the library rounds them for its products): each within one bf16 ulp
    of its largest magnitude at keys below M, and exactly 0 at keys in
    [M, ds_pitch(M))."""
    m = k.shape[1]
    for name, ws, ref in zip(("dS", "P"), workspaces,
                             PA.flash_bwd_ds_plain(q, k, v, lse, do, di, scale)):
        err = (ws[..., :m].float() - ref[..., :m].float()).abs().max().item()
        lim = ulp_bf16(ref)
        pad = ws[..., m:]
        zeros = bool((pad == 0).all())
        print(f"    the {name} workspace {tuple(ws.shape)} against flash_bwd_ds_plain: "
              f"max_abs_err {err:.3e} (tol {lim:.3e}, one bf16 ulp of max |{name}|); the "
              f"{pad.shape[-1]} keys past M hold 0: {zeros}", flush=True)
        if not (err <= lim and zeros):
            fail(f"the bf16 {name} workspace is not flash_bwd_ds_plain's")


def check_train_kernels(gen, shapes):
    """The residual forward (o, lse), K4 (dk, dv) and K5 (dq) against their
    plain versions at `shapes`, bf16 and fp32 (the backward kernels and
    their plain versions get the same plain o and lse). Returns the worst
    errors by kernel.

    At each bf16 shape it also reads three faults the limits must catch:
    the plain forward's o with its last key tile dropped (the bf16
    forward's kBN keys), the plain dV with its last 64-key tile dropped,
    and the plain dQ without the last 64 keys' contribution. At d > 128 in
    bf16 K5's call writes the dS and P workspaces into tensors filled with
    NaN, which check_workspaces then holds to flash_bwd_ds_plain; K4 runs
    its GEMM from them, and alone, with its own dS/P launch, and
    flash_attention_bwd runs both from one dS/P launch: the same bits."""
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
            if kind == "bf16" and d > 128:  # NaN shows any element left unwritten
                ws = tuple(torch.full((bh, n, PA.ds_pitch(m)), math.nan, dtype=dt, device="cuda")
                           for _ in range(2))
                dq = PA.flash_bwd_dq(q, k, v, lse_ref, do, di, scale, workspace=ws[0],
                                     p_workspace=ws[1])
                dk, dv = PA.flash_bwd_dkv(q, k, v, lse_ref, do, di, scale, workspaces=ws)
                torch.cuda.synchronize()
                check_workspaces(ws, q, k, v, lse_ref, do, di, scale)
                alone = PA.flash_bwd_dkv(q, k, v, lse_ref, do, di, scale)
                fused = PA.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, scale)
                same = torch.equal(alone[0], dk) and torch.equal(alone[1], dv)
                same_bwd = all(map(torch.equal, fused, (dq, dk, dv)))
                print(f"    flash_bwd_dkv alone (its own dS/P launch) bit-equal to its GEMM on "
                      f"K5's workspaces: {same}; flash_attention_bwd (FlashAttention's "
                      f"backward: one dS/P launch for both) bit-equal: {same_bwd}", flush=True)
                if not (same and same_bwd):
                    fail("flash_bwd_dkv alone or flash_attention_bwd disagrees with the GEMMs "
                         "on K5's workspaces")
                del ws, alone, fused
            else:
                dk, dv = PA.flash_bwd_dkv(q, k, v, lse_ref, do, di, scale)
                dq = PA.flash_bwd_dq(q, k, v, lse_ref, do, di, scale)
            torch.cuda.synchronize()
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
    of PRs 2-4. At d > 128 each is timed as flash_attention_bwd runs it: K5's
    call is the dS/P launch (the dS and P workspaces written once) and the
    dQ GEMM (dS read once), K4's the dV/dK GEMM (dS and P read once); K4
    alone, with its own dS/P launch, is timed beside it. Returns {key:
    {shape: stats}} for the JSON rows."""
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
        ws_b = 2 * bh * n * PA.ds_pitch(m)  # one bf16 workspace, written or read once
        io = lambda *sizes: 2 * sum(bh * x * d for x in sizes)  # bf16 operands
        exps = float(bh * n * m)  # one exp2 a score, in the forward and in each backward kernel
        dkv = lambda: PA.flash_bwd_dkv(q, k, v, lse, do, di, scale)
        dq = lambda: PA.flash_bwd_dq(q, k, v, lse, do, di, scale)
        k4 = (8.0 * bh * n * m * d, io(n, m, m, n, m, m) + 2 * lse_b)
        k5 = (6.0 * bh * n * m * d, io(n, m, m, n, n) + 2 * lse_b)
        if d > 128:  # the split backward, as flash_attention_bwd runs it
            ws = tuple(torch.empty((bh, n, PA.ds_pitch(m)), dtype=torch.bfloat16, device="cuda")
                       for _ in range(2))
            dq = lambda: PA.flash_bwd_dq(q, k, v, lse, do, di, scale, workspace=ws[0],
                                         p_workspace=ws[1])
            dq()
            dkv = lambda: PA.flash_bwd_dkv(q, k, v, lse, do, di, scale, workspaces=ws)
            k4 = (4.0 * bh * n * m * d, io(n, m, m) + 2 * ws_b)  # q, do in; dk, dv out
            k5 = (6.0 * bh * n * m * d, io(n, m, m, n, n) + 2 * lse_b + 3 * ws_b)
        rows = {
            "K2r": (lambda: PA.flash_attention_fwd(q, k, v, scale),
                    lambda: PA.flash_attention_fwd_plain(q, k, v, scale),
                    4.0 * bh * n * m * d, io(n, m, m, n) + lse_b, sdpa_fwd),
            "K4": (dkv, lambda: PA.flash_bwd_dkv_plain(q, k, v, lse, do, di, scale), *k4,
                   sdpa_bwd),
            "K5": (dq, lambda: PA.flash_bwd_dq_plain(q, k, v, lse, do, di, scale), *k5,
                   sdpa_bwd),
        }
        for key, (kern, plain, ops, nbytes, lib) in rows.items():
            ms, plain_ms = time_ms(kern), time_ms(plain)
            b, by = bound_ms(nbytes, ops, "bf16", 0.0 if key == "K4" and d > 128 else exps)
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
        if d > 128:  # K4 alone: its own dS/P launch, then the GEMM
            alone = time_ms(lambda: PA.flash_bwd_dkv(q, k, v, lse, do, di, scale))
            stats["K4"][(bh, n, m, d)]["alone_ms"] = alone
            print(f"  K4 bf16 alone (its own dS/P launch, then the GEMM): {alone:.4f} ms",
                  flush=True)
            del ws
        del q, k, v, do, o, lse, di, qg, kg, vg, dq, dkv
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
    run without gradients through K2. K3 for each GroupNorm32 of the two
    encodes and of the noisy input's decode (no autograd records them); the
    UNet's and the other decodes' norms take the plain version. No K1. The
    plan counts wrapper
    calls: at d=512 flash_attention_bwd makes one flash_bwd_dq call of two
    launches (dS and P, then dQ = dS K: K5's row owns the shared dS/P
    launch) and one flash_bwd_dkv call of one (dV and dK from them)."""
    passes = 1 + recon.ddim_steps
    unet = {(8 * batch, 4096, 4096, 40): 5, (8 * batch, 1024, 1024, 80): 5}
    wide = (batch, 4096, 4096, 512)
    n_dec, n_grad = 3, 2
    enc, dec = vae_norms(VAEConfig(), batch, 512)
    return {
        "self_attention_smalld": {},
        "wide_attention": {wide: 2},
        "group_norm_silu": dict(scaled(enc, 2) + dec),
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


# ------------------------------------------------------------------ phase 13

CLI_BATCH = 4
CLI_STEPS = 4
CELEBA_ITEMS, CELEBA_TRAIN, CELEBA_SIZE = 16, 12, 1024
FFHQ_ITEMS, FFHQ_SIZE = 4, 512
SAMPLE_BATCH, SAMPLE_STEPS = 2, 8  # cli.train's sample swaps
# Phase 13: one split_grad=2 step with the bf16 accumulator against the same
# step with the fp32 one, on the same state, batch and draws. The recon
# gradient is rounded to bf16 (2^-9 relative) before the sum and the chain's
# pullback runs at the trainable weights rounded to bf16; AdamW's update
# carries that through about linearly. Two fp32 split steps alone differ by
# ~3e-4 (phase 8's SPLIT_TOL note). Limit, set before the first run: 1e-2
# relative L2 of the update over all trainable tensors.
ACC_TOL = 1e-2


class Tee:
    """stdout for a driver run: printed as it comes, and kept."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


class LaunchLog:
    """The launches of each call of the wrapped trainer functions, by kernel
    and shape: make_train_step's step and loss (validation) functions and
    FaceSwapper.swap (the sample swaps), patched for one driver run; and the
    weights the first step starts from. The patched init_state re-randomises
    the reference's zero-initialised layers."""

    def __init__(self):
        self.calls = collections.defaultdict(list)
        self.snapshot = None

    @contextlib.contextmanager
    def scope(self, kind):
        for k in KERNELS:
            k.shapes = collections.Counter()
        try:
            yield
        finally:
            self.calls[kind].append({k.__name__: dict(k.shapes) for k in KERNELS})
            for k in KERNELS:
                k.shapes = None

    @contextlib.contextmanager
    def patched(self):
        import reface_tpu_torch.pipelines.train as PT

        make, swap = PT.make_train_step, FaceSwapper.swap

        def make_logged(*a, **kw):
            step_fn, loss_fn, init_state = make(*a, **kw)

            def step(state, batch, **kw2):
                if self.snapshot is None:  # the weights the first step starts from
                    self.snapshot = {k: p.detach().to("cpu", copy=True)
                                     for k, p in named_params(state.modules).items()}
                with self.scope("step"):
                    return step_fn(state, batch, **kw2)

            def loss(modules, batch, **kw2):
                with self.scope("val"):
                    return loss_fn(modules, batch, **kw2)

            def init(*a2, **kw2):
                # the reference's zero-initialised layers re-randomised, as in
                # phases 7 and 8: a zero bias behind a one-token cross-attention
                # gets no gradient and no weight decay, and would not move
                state = init_state(*a2, **kw2)
                for i, m in enumerate(state.modules.towers().values()):
                    init_params(m, seed=i, dezero=True)
                return state

            return step, loss, init

        def swap_logged(sw, *a, **kw):
            with self.scope("sample"):
                return swap(sw, *a, **kw)

        PT.make_train_step, FaceSwapper.swap = make_logged, swap_logged
        try:
            yield self
        finally:
            PT.make_train_step, FaceSwapper.swap = make, swap


def val_loss_plan(recon, batch: int) -> dict:
    """Launches of one validation batch of the full loss under no_grad: each
    UNet pass's 10 flash self-attentions once (no remat without a graph),
    the three collected latents decoded once each through FlashAttention at
    d=512 (the training VAE's decoder), the two encodes through K2; K3 for
    every GroupNorm32 of them all."""
    passes = 1 + recon.ddim_steps
    wide = (batch, 4096, 4096, 512)
    enc, dec = vae_norms(VAEConfig(), batch, 512)
    k3 = scaled(enc, 2) + scaled(dec, 3) + scaled(unet_norms(UNetConfig(), batch, 64), passes)
    return {"self_attention_smalld": {}, "wide_attention": {wide: 2}, "group_norm_silu": dict(k3),
            "flash_attention_fwd": {(8 * batch, 4096, 4096, 40): 5 * passes,
                                    (8 * batch, 1024, 1024, 80): 5 * passes, wide: 3},
            "flash_bwd_dkv": {}, "flash_bwd_dq": {}}


def sample_plan(cfg: SwapConfig) -> dict:
    """Launches of one sample swap (mode_plan at 8 DDIM steps, batch 2), by
    wrapper and shape."""
    p = mode_plan(dataclasses.replace(cfg, ddim_steps=SAMPLE_STEPS), SAMPLE_STEPS,
                  batch=SAMPLE_BATCH)
    nonzero = lambda c: {k: v for k, v in c.items() if v}
    return {"self_attention_smalld": nonzero(p["K1"]), "wide_attention": nonzero(p["K2"]),
            "group_norm_silu": dict(p["K3 shapes"]), "flash_attention_fwd": {},
            "flash_bwd_dkv": {}, "flash_bwd_dq": {}}


def eps_step_plan(batch: int) -> dict:
    """Launches of one eps-MSE step (phase 7's TRAIN_PLAN) by wrapper and shape."""
    unet = {(8 * batch, 4096, 4096, 40): 5, (8 * batch, 1024, 1024, 80): 5}
    return {"self_attention_smalld": {}, "wide_attention": {(batch, 4096, 4096, 512): 2},
            "group_norm_silu": dict(scaled(vae_norms(VAEConfig(), batch, 512)[0], 2)),
            "flash_attention_fwd": {k: 2 * c for k, c in unet.items()},
            "flash_bwd_dkv": unet, "flash_bwd_dq": unet}


def check_calls(log: LaunchLog, kind: str, plan: dict, n: int):
    calls = log.calls[kind]
    if len(calls) != n:
        fail(f"cli.train: {len(calls)} {kind} calls, expected {n}")
    for i, got in enumerate(calls):
        if got != plan:
            fail(f"cli.train {kind} call {i}: launches by shape {got}, planned {plan}")


def read_jsonl(path) -> list:
    return [json.loads(line) for line in Path(path).read_text().splitlines() if line]


def run_driver(main_fn, argv) -> tuple:
    """(return value, stdout text) of a driver's main(argv)."""
    import sys

    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = main_fn(argv)
    return out, "".join(tee.text)


def check_state_equals_files(path: str, state):
    """The state just loaded from a ckpt/io.py checkpoint, bit-equal to its
    files: every tower's tensors, AdamW's mu and nu, its counters, the step
    and the EMA shadow."""
    params = ckpt_io.load_params(path)
    tree = torch.load(Path(path) / ckpt_io.STATE_FILE, map_location="cpu",
                      weights_only=True, mmap=True)
    bad, n = [], 0
    for name, m in state.modules.towers().items():
        for k, t in m.state_dict().items():
            n += 1
            if not torch.equal(t, params[name][k].to(t.device)):
                bad.append(f"{name}.{k}")
    opt = state.opt
    for key in ("mu", "nu"):
        for name, t in zip(opt.names, getattr(opt, key)):
            n += 1
            if not torch.equal(t, tree["opt"][key][name].to(t.device)):
                bad.append(f"{key}.{name}")
    for k, t in state.ema.shadow.items():
        n += 1
        if not torch.equal(t, tree["ema"]["shadow"][k].to(t.device)):
            bad.append(f"ema.{k}")
    scalars = (state.step, opt.count, opt.mini_step, state.ema.updates)
    want = (tree["step"], tree["opt"]["count"], tree["opt"]["mini_step"],
            tree["ema"]["updates"])
    if bad or scalars != want:
        fail(f"the resumed state differs from its checkpoint: {bad[:10]}, counters "
             f"{scalars} vs {want}")
    return n


def train_cli_data(d: Path) -> dict:
    """The phase's files: a CelebA-style tree (1024 px JPEGs, the per-class
    mask PNGs merged by cli.prepare_data merge-celeba-masks), an FFHQ-style
    tree, a seeded LPIPS module dump, LandmarkNet and BiSeNet state dicts."""
    celeba, ffhq = d / "celeba", d / "ffhq"
    make_synthetic_celeba(str(celeba), count=CELEBA_ITEMS, size=CELEBA_SIZE, seed=13,
                          class_masks=True)
    cli_prepare.main(["merge-celeba-masks", "--dataset-dir", str(celeba),
                      "--count", str(CELEBA_ITEMS)])
    merged = sorted((celeba / "CelebA-HQ-mask" / "Overall_mask").glob("*.png"))
    if len(merged) != CELEBA_ITEMS:
        fail(f"merge-celeba-masks wrote {len(merged)} masks, expected {CELEBA_ITEMS}")
    make_synthetic_ffhq(str(ffhq), count=FFHQ_ITEMS, size=FFHQ_SIZE, seed=14)
    files = {"celeba": celeba, "ffhq": ffhq}
    for name, module, seed in (("lpips", LPIPS(), 5),
                               ("landmarks", LandmarkNet(LandmarkNetConfig()), 6),
                               ("bisenet", BiSeNet(BiSeNetConfig()), 7)):
        files[name] = d / f"{name}.pth"
        torch.save(init_params(module, seed=seed).state_dict(), files[name])
    return files


def train_cli_path(smi: str, gen) -> dict:
    """Phase 13: cli.train at full width with the full losses, its save and
    resume, a bf16-accumulator step, the eps-MSE run, cli.swap on the trained
    checkpoint and cli.prepare_data. Returns its stats."""
    cfg = SwapConfig()
    recon = ReconLossConfig()
    d = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    free = shutil.disk_usage(d).free
    print(f"  free disk space under {d.parent}: {free / 2**30:.1f} GiB", flush=True)
    stats = {"free_disk_gib": free / 2**30}
    try:
        t0 = time.perf_counter()
        files = train_cli_data(d)
        stats["data_s"] = time.perf_counter() - t0
        print(f"  wrote a CelebA-style tree of {CELEBA_ITEMS} {CELEBA_SIZE} px items (masks "
              f"merged by cli.prepare_data merge-celeba-masks), an FFHQ-style tree of "
              f"{FFHQ_ITEMS}, seeded LPIPS, LandmarkNet and BiSeNet files in "
              f"{stats['data_s']:.1f} s", flush=True)
        common = ["--dataset-dir", str(files["celeba"]), "--dataset", "celeba",
                  "--batch-size", str(CLI_BATCH), "--full-losses", "--train-count",
                  str(CELEBA_TRAIN), "--lpips-ckpt", str(files["lpips"]),
                  "--landmark-ckpt", str(files["landmarks"]), "--ema-decay", "0.9999",
                  "--log-every", "1", "--warmup-steps", "1"]

        # run A: 4 steps, validation, samples, checkpoints
        a = d / "runA"
        log = LaunchLog()
        reset_counts()  # the trainer's run starts here
        with log.patched():
            state, out = run_driver(cli_train.main, common + [
                "--logdir", str(a), "--steps", str(CLI_STEPS), "--image-log-every", "2",
                "--sample-log-every", "4", "--val-every", "2", "--val-count", "4",
                "--keep-top-k", "1", "--ckpt-every", "2"])
        launches_a = counts()
        check_calls(log, "step", full_loss_plan(recon, CLI_BATCH), CLI_STEPS)
        check_calls(log, "val", val_loss_plan(recon, CLI_BATCH), 2)
        check_calls(log, "sample", sample_plan(cfg), 1)
        metrics = read_jsonl(a / "metrics.jsonl")
        vals = [v for m in metrics for k, v in m.items() if "loss" in k]
        if len(metrics) != CLI_STEPS + 2 or not all(map(math.isfinite, vals)):
            fail(f"run A's metrics: {metrics}")
        named = named_params(state.modules)
        labels = trainable_labels(named)
        moved = {k for k, p in named.items() if not torch.equal(p.cpu(), log.snapshot[k])}
        stuck = ([k for k in moved if labels[k] == "freeze"]
                 + [k for k in named if labels[k] == "train" and k not in moved])
        ckpts = sorted(p.name for p in (a / "checkpoints").iterdir())
        imgs = sorted(p.name for p in (a / "images").iterdir())
        want_imgs = ["inputs_00000002.png", "inputs_00000004.png", "samples_00000004.png"]
        n_best = sum(c.startswith("best_") for c in ckpts)
        if stuck or state.step != CLI_STEPS:
            fail(f"run A: step {state.step}; trainable tensors that did not move or frozen "
                 f"ones that did: {stuck[:8]}")
        if ({"step_00000002", "step_00000004", "last"} - set(ckpts) or n_best != 1
                or imgs != want_imgs):
            fail(f"run A wrote checkpoints {ckpts} and images {imgs}")
        del state, named, log.snapshot
        torch.cuda.empty_cache()
        timing = read_jsonl(a / "timing.jsonl")
        steps = [r for r in timing if "step_s" in r]
        steady = steps[1:]
        step_s = sum(r["step_s"] for r in steady) / len(steady)
        wait = sum(r["loader_wait_s"] for r in steady) / sum(r["step_s"] for r in steady)
        peak = max(r.get("peak_bytes_in_use", 0) for r in steps)
        saves = [{k: r[k] for k in ("ckpt", "bytes", "save_s")} for r in timing if "ckpt" in r]
        stats["run_a"] = {"step_s": [r["step_s"] for r in steps], "steady_step_s": step_s,
                          "samples_per_s": CLI_BATCH / step_s, "loader_wait_share": wait,
                          "loader_wait_s": [r["loader_wait_s"] for r in steps],
                          "peak_gib": peak / 2**30, "saves": saves,
                          "launches": dict(zip(("K1", "K2", "K3", "K2r", "K4", "K5"),
                                               launches_a))}
        print(f"  run A ({smi}): cli.train --full-losses --batch-size {CLI_BATCH} at "
              f"{cfg.image_size} px, {CLI_STEPS} steps: losses finite, all "
              f"{sum(v == 'train' for v in labels.values())} trainable tensors moved and none "
              f"of the {sum(v == 'freeze' for v in labels.values())} frozen ones; step time "
              f"first {steps[0]['step_s']:.3f} s, steady {step_s:.3f} s, "
              f"{CLI_BATCH / step_s:.3f} samples/s; loader wait {100 * wait:.2f}% of the "
              f"steady steps ({[round(r['loader_wait_s'], 4) for r in steps]} s); peak "
              f"{peak / 2**30:.2f} GiB; launches (K1, K2, K3, K2r, K4, K5) {launches_a}, each "
              f"step, validation batch and sample swap as planned by shape; files "
              f"{ckpts} + {imgs}", flush=True)
        for s in saves:
            print(f"    checkpoint {s['ckpt']}: {s['bytes'] / 2**30:.3f} GiB in "
                  f"{s['save_s']:.2f} s", flush=True)

        # run B: resume from step 2, bit-equal, to step 4 (two full
        # checkpoints at most on disk: the one resumed from and B's last)
        src = a / "checkpoints" / "step_00000002"
        for c in (a / "checkpoints").iterdir():
            if c != src:
                shutil.rmtree(c)
        b = d / "runB"
        load, checked = ckpt_io.load_train_state, {}

        def load_checked(path, st):
            load(path, st)
            torch.cuda.synchronize()
            checked["n"] = check_state_equals_files(path, st)
            return st

        ckpt_io.load_train_state = load_checked
        try:
            torch.cuda.reset_peak_memory_stats()
            state, out = run_driver(cli_train.main, common + [
                "--logdir", str(b), "--steps", str(CLI_STEPS), "--resume", str(src)])
        finally:
            ckpt_io.load_train_state = load
        if "resumed FULL train state at step 2" not in out or state.step != CLI_STEPS \
                or "n" not in checked:
            fail(f"run B did not resume the full state at step 2 and end at step "
                 f"{CLI_STEPS} (step {state.step})")
        resume = [r for r in read_jsonl(b / "timing.jsonl") if "resume_load_s" in r][0]
        stats["run_b"] = {"load_s": resume["resume_load_s"],
                          "peak_gib_at_resume": resume.get("peak_bytes_in_use", 0) / 2**30,
                          "tensors_bit_equal": checked["n"]}
        print(f"  run B: resumed FULL train state at step 2 in {resume['resume_load_s']:.2f} s "
              f"(peak {stats['run_b']['peak_gib_at_resume']:.2f} GiB at resume), all "
              f"{checked['n']} tensors and the counters bit-equal to the files; ended at step "
              f"{state.step}", flush=True)

        # cli.swap --precropped on run B's last parameters file, against
        # FaceSwapper.swap on the same weights in memory (bf16, as the driver)
        params_file = b / "checkpoints" / "last" / ckpt_io.PARAMS_FILE
        direct = FaceSwapper(cfg, {n: sd for n, sd in state.params().items()
                                   if n in ("unet", "vae", "conditioner")}, device="cuda")
        cli_common._round_weights(direct.towers().values(), torch.bfloat16)
        src_img = photo_like(80, cfg.image_size, cfg.image_size)
        images.imwrite(d / "source.png", src_img)
        images.imwrite(d / "target.png", photo_like(81, cfg.image_size, cfg.image_size))
        src01 = cli_swap._read01(str(d / "source.png"))
        ref = clip_normalize(torch.from_numpy(src01[None]).cuda().permute(0, 3, 1, 2))
        tgt = cli_swap._read01(str(d / "target.png"), cfg.image_size)[None] * 2 - 1
        mask = cli_common.default_inpaint_mask(cfg.image_size)[None]
        want = direct.swap(target_image=tgt, inpaint_image=tgt * mask, inpaint_mask=mask,
                           ref_clip224=ref.permute(0, 2, 3, 1),
                           generator=torch.Generator(device="cuda").manual_seed(5))
        want = ((want[0].cpu() + 1) / 2).clamp(0, 1)
        del direct, ref
        torch.cuda.empty_cache()
        # one split_grad=2 step from step 2's state, bf16 accumulator vs fp32
        ds = CelebAHQDataset(CelebAHQConfig(dataset_dir=str(files["celeba"]),
                                            image_size=cfg.image_size,
                                            train_count=CELEBA_TRAIN, data_seed=0))
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 collate([ds[i] for i in range(CLI_BATCH)]).items()}
        batch = {"target_image": batch["GT"], "inpaint_image": batch["inpaint_image"],
                 "inpaint_mask": batch["inpaint_mask"], "ref_clip224": batch["ref_imgs"]}
        g = torch.Generator(device="cuda").manual_seed(21)
        draws = make_draws(CLI_BATCH, cfg.latent_size, TrainConfig(), "cuda", g)
        trainable = [p for p in named_params(state.modules).values() if p.requires_grad]
        deltas = {}
        for acc in ("float32", "bfloat16"):
            tcfg = TrainConfig(learning_rate=1e-5 * CLI_BATCH, warmup_steps=1, ema_decay=0.9999,
                               split_grad=2, split_acc_dtype=acc)
            step_fn = make_train_step(cfg, tcfg, recon=recon, device="cuda")[0]
            load(str(src), state)
            p0 = [p.detach().clone() for p in trainable]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t1 = time.perf_counter()
            state, m = step_fn(state, batch, draws)
            torch.cuda.synchronize()
            # the step's own peak: above what was resident when it began
            # (the state, the copy of the weights, the other step's update)
            peak = torch.cuda.max_memory_allocated() - resident
            deltas[acc] = ([p.detach() - q for p, q in zip(trainable, p0)],
                           time.perf_counter() - t1, m["loss"].item(), peak)
            del p0
        (d32, s32, l32, m32), (d16, s16, l16, m16) = deltas["float32"], deltas["bfloat16"]
        num = sum((x - y).double().pow(2).sum() for x, y in zip(d16, d32))
        rel = float((num / sum(y.double().pow(2).sum() for y in d32)).sqrt())
        stats["bf16_accumulator"] = {"update_rel_l2": rel, "tol": ACC_TOL, "loss": [l32, l16],
                                     "step_s": [s32, s16],
                                     "step_peak_gib": [m32 / 2**30, m16 / 2**30]}
        print(f"  one split_grad=2 step from step 2's state: the bf16 accumulator's update "
              f"within {rel:.3e} relative L2 of the fp32 one's over {len(d32)} trainable "
              f"tensors (limit {ACC_TOL:.0e}); loss {l32:.6f} / {l16:.6f}; {s32:.2f} / "
              f"{s16:.2f} s; the step's peak above the resident memory {m32 / 2**30:.2f} / "
              f"{m16 / 2**30:.2f} GiB (fp32 / bf16)", flush=True)
        if not rel <= ACC_TOL:
            fail("the bf16 split-grad accumulator's update is off the fp32 one's")
        del deltas, d32, d16, trainable, state, m
        torch.cuda.empty_cache()

        reset_counts()
        done = cli_swap.main(["--precropped", "--ckpt", str(params_file), "--seed", "5",
                              "--source", str(d / "source.png"), "--target",
                              str(d / "target.png"), "--outdir", str(d / "swapped")])
        got = images.imread(done[0][0])
        diff = (torch.from_numpy(got).float() / 255 - want).abs().max().item()
        stats["cli_swap_levels_from_direct"] = diff * 255
        print(f"  cli.swap --precropped --ckpt {params_file.relative_to(d)} "
              f"({params_file.stat().st_size / 2**30:.3f} GiB): within {diff * 255:.3f} levels "
              f"of FaceSwapper.swap on the trained weights in memory (limit 1); launches "
              f"(K1, K2, K3) {counts()[:3]}", flush=True)
        if diff > LEVEL + 1e-6:
            fail(f"cli.swap on the trained checkpoint is {diff * 255:.3f} levels off")

        # cli.prepare_data expand-sd-checkpoint on a 4-channel SD-layout file
        # made from the trained weights
        trained = ckpt_io.load_params(str(params_file))
        conv_in = "input_blocks.0.0.weight"
        sd4 = {**{UNET_PREFIX + k: v for k, v in trained["unet"].items()},
               **{VAE_PREFIX + k: v for k, v in trained["vae"].items()}}
        sd4[UNET_PREFIX + conv_in] = trained["unet"][conv_in][:, :4].clone()
        torch.save({"state_dict": sd4}, d / "sd4.ckpt")
        sd4_gib = (d / "sd4.ckpt").stat().st_size / 2**30
        t1 = time.perf_counter()
        cli_prepare.main(["expand-sd-checkpoint", "--src", str(d / "sd4.ckpt"),
                          "--dst", str(d / "sd9.ckpt")])
        expand_s = time.perf_counter() - t1
        sd9 = torch.load(d / "sd9.ckpt", map_location="cpu", weights_only=True,
                         mmap=True)["state_dict"]
        w9 = sd9[UNET_PREFIX + conv_in]
        same = set(sd9) == set(sd4) and all(
            torch.equal(sd9[k], v) for k, v in sd4.items() if k != UNET_PREFIX + conv_in)
        if (w9.shape[1] != 9 or not torch.equal(w9[:, :4], sd4[UNET_PREFIX + conv_in])
                or w9[:, 4:].any() or not same):
            fail("expand-sd-checkpoint did not zero-pad conv_in to 9 channels alone")
        del trained, sd4, sd9, w9
        print(f"  cli.prepare_data expand-sd-checkpoint: a {sd4_gib:.2f} GiB "
              f"SD-layout file, conv_in (320, 4, 3, 3) -> (320, 9, 3, 3) zero-padded, every "
              f"other tensor equal, in {expand_s:.1f} s", flush=True)
        for f in ("sd4.ckpt", "sd9.ckpt"):
            (d / f).unlink()
        shutil.rmtree(a)
        shutil.rmtree(b)

        # the eps-MSE run on the FFHQ tree
        log = LaunchLog()
        reset_counts()
        with log.patched():
            state, _ = run_driver(cli_train.main, [
                "--dataset-dir", str(files["ffhq"]), "--dataset", "ffhq", "--logdir",
                str(d / "runE"), "--batch-size", "2", "--train-count", str(FFHQ_ITEMS),
                "--steps", "2", "--log-every", "1", "--no-final-ckpt"])
        launches_e = counts()
        check_calls(log, "step", eps_step_plan(2), 2)
        metrics = read_jsonl(d / "runE" / "metrics.jsonl")
        if state.step != 2 or not all(math.isfinite(m["loss"]) for m in metrics):
            fail(f"the eps-MSE run: step {state.step}, metrics {metrics}")
        e_steps = [r["step_s"] for r in read_jsonl(d / "runE" / "timing.jsonl") if "step_s" in r]
        stats["eps_run"] = {"step_s": e_steps, "launches": dict(zip(
            ("K1", "K2", "K3", "K2r", "K4", "K5"), launches_e))}
        print(f"  the eps-MSE run on the FFHQ tree (batch 2, 2 steps, no final save): losses "
              f"{[round(m['loss'], 5) for m in metrics]}, step times {e_steps} s, launches "
              f"{launches_e} as planned by shape", flush=True)
        del state
        torch.cuda.empty_cache()

        # estimate-ffhq-masks and crop-and-mask with the seeded files
        ffhq_imgs = sorted((files["ffhq"] / "images512").glob("*.png"))
        shutil.rmtree(files["ffhq"] / "BiSeNet_mask")
        t1 = time.perf_counter()
        cli_prepare.main(["estimate-ffhq-masks", "--dataset-dir", str(files["ffhq"]),
                          "--bisenet-ckpt", str(files["bisenet"]), "--batch", "4"])
        est_s = time.perf_counter() - t1
        net = BiSeNet(BiSeNetConfig(), device="cuda")
        net.load_state_dict(torch.load(files["bisenet"], weights_only=True))
        x = torch.stack([torch.from_numpy(images.imread(p)) for p in ffhq_imgs]).cuda()
        with torch.inference_mode():
            direct_masks = parse_faces(net.eval(), x.permute(0, 3, 1, 2).float() / 255).cpu()
        got = torch.stack([torch.from_numpy(images.imread(
            files["ffhq"] / "BiSeNet_mask" / p.name, gray=True)) for p in ffhq_imgs])
        if got.shape != (FFHQ_ITEMS, FFHQ_SIZE, FFHQ_SIZE) or not torch.equal(
                got.long(), direct_masks.long()):
            fail("estimate-ffhq-masks differs from BiSeNet called directly")
        t1 = time.perf_counter()
        cli_prepare.main(["crop-and-mask", "--dataset-dir", str(files["celeba"]), "--out-dir",
                          str(d / "crops"), "--start", "0", "--count", "2", "--landmark-ckpt",
                          str(files["landmarks"]), "--bisenet-ckpt", str(files["bisenet"])])
        crop_s = time.perf_counter() - t1
        crops = [images.imread(d / "crops" / "crops" / f"{i}.png") for i in range(2)]
        masks = [images.imread(d / "crops" / "masks" / f"{i}.png", gray=True) for i in range(2)]
        size = RawPipelineConfig().align_size
        if [c.shape for c in crops] != [(size, size, 3)] * 2 or \
                [m.shape for m in masks] != [(size, size)] * 2 or max(m.max() for m in masks) > 11:
            fail(f"crop-and-mask wrote {[c.shape for c in crops]} / {[m.shape for m in masks]}")
        stats["prepare_data"] = {"expand_s": expand_s, "estimate_ffhq_masks_s": est_s,
                                 "crop_and_mask_s": crop_s}
        print(f"  cli.prepare_data estimate-ffhq-masks: {FFHQ_ITEMS} masks equal to BiSeNet "
              f"called directly, {est_s:.1f} s; crop-and-mask on 2 {CELEBA_SIZE} px images: "
              f"{size} px crops and seg12 masks, {crop_s:.1f} s", flush=True)
        stats["launches_train_cli"] = {"run_a": stats["run_a"]["launches"],
                                       "eps_run": stats["eps_run"]["launches"]}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return stats


# ------------------------------------------------------------------ phase 15

# Phase 15: the remaining trainers. cli.distill at SwapConfig() widths, 512
# px, batch 4, round 0 of 50 -> 10 (windows of 5 teacher steps under CFG 3);
# cli.train_vae at VAEConfig() widths, 256 px, batch 4; cli.train_landmarks
# at LandmarkNetConfig(), 256 px.
DISTILL_BATCH, DISTILL_STEPS, DISTILL_ITEMS, DISTILL_K = 4, 3, 8, 5
VAE_SIZE, VAE_BATCH, VAE_IMAGES = 256, 4, 8
VAE_WIDE = (VAE_BATCH, (VAE_SIZE // 8) ** 2, (VAE_SIZE // 8) ** 2, 512)
LM_SIZE, LM_FACES, LM_STEPS, LM_BATCH = 256, 192, 300, 32
# The shapes the trainers add: the teacher's self-attention at batch 8 (CFG
# doubling of 4: 16 x 8 heads), the VAE's mid-block at 256 px.
TEACHER_SHAPES = ((16 * DISTILL_BATCH, 4096, 4096, 40), (16 * DISTILL_BATCH, 1024, 1024, 80))
# Phase 15, the tiny fp32 runs on the card against the CPU port: the losses
# (the distillation's passes through 2 and 5 teacher steps) as phase 7's
# tiny step (1e-5 relative), and the student after two Adam steps at lr 1e-5
# within 1e-4 relative L2 (an element whose gradient rounds to the other
# sign on the other side moves by 2e-5 there).
TRAINER_TINY_TOL = {"loss": 1e-5, "weights": 1e-4, "grad": 1e-4}
# Phase 15, a distillation step with flash attention against einsum (bf16):
# the student's gradient at phase 7's limit (seen 2.4e-3 to 2.6e-3); the
# teacher window's end at the same 1e-2 (seen 4.2e-3); the loss at 1e-3. It
# was first held to phase 7's 2e-4 and read 1.29e-4, 2.80e-4 (both towers
# switched) and 2.61e-4 (the student alone) on the H100 (80GB HBM3, 700 W):
# the loss is the weighted MSE of the student's eps against a target close
# to it, so a relative change of eps moves it by about twice that change
# over the residual's relative size, where phase 7's MSE against the noise
# does not amplify it (seen 2.3e-5 there). Measured since (ROADMAP C3): the
# same step on fp32 copies of both UNets reads 7.85e-8 (loss) and 4.9e-7
# (gradient), bf16 1.92e-4 in the same run (H100 80GB HBM3, 700 W): the
# distance is bf16's rounding, not the kernels'.
DISTILL_TOL = {"loss": 1e-3, "grad": 1e-2, "window": 1e-2}
# The tiny VAE step's gradients: first held card vs CPU to 1e-4 (phase 7's
# limit), they read 9.06e-4 at the encoder's conv_in (gate open) on the
# H100 (80GB HBM3, 700 W), twice. Against a float64 run of the same step, the CPU port's fp32
# gradient reads 1.09e-3 at that tensor on one host (this repository's CPU
# test machine) and 2.50e-4 at worst on the card's host, and the card's
# 9.31e-4: fp32 rounding alone moves the first layers' gradients, which come
# back through the L1 term's signs summed over every pixel, by up to ~1e-3,
# the amount depending on the CPU's summation order. So the card is held to
# the float64 run within the larger of VAE_TINY_FP64 times the CPU port's
# fp32 distance in the same run and VAE_TINY_ABS (~2x the largest fp32
# distance read on a CPU). The limits were set after those readings.
VAE_TINY_FP64 = 2.0
VAE_TINY_ABS = 2e-3


# ROADMAP C3: the same distillation step, flash against einsum, on fp32
# copies of the student and the teacher (the kernels' fp32 versions, TF32
# off). Where the bf16 distance of the loss comes from bf16's rounding of
# eps, amplified by the loss's form, it falls here to fp32's summation-order
# distance: the loss within phase 7's tiny fp32 limit, the gradient within
# phase 7's einsum limit.
DISTILL_FP32_TOL = {"loss": 1e-5, "grad": TRAIN_TOL["grad"]}


def distill_fp32_vs_einsum(student, teacher, loss_fn, inputs, draws) -> dict:
    """One distillation step's loss and student gradient, the student's
    attention flash against einsum (the teacher's flash), on fp32 copies of
    both UNets with the same weights and inputs."""
    copies = []
    for unet in (student, teacher):
        m = UNetModel(dataclasses.replace(unet.config, dtype=torch.float32), device=DEV)
        m.load_state_dict(unet.state_dict())
        copies.append(m.requires_grad_(unet is student))
    s32, t32 = copies
    inputs32 = tuple(t.float() for t in inputs)
    params = list(s32.parameters())

    def loss_and_grads():
        loss, _ = loss_fn(s32, t32, *inputs32, draws)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.item(), {i: g.float() for i, g in enumerate(gs) if g is not None}

    loss_f, g_f = loss_and_grads()
    set_unet_attn(s32, "einsum")
    loss_e, g_e = loss_and_grads()
    rel_loss, rel_grad = abs(loss_f - loss_e) / abs(loss_e), rel_l2(g_f, g_e)
    del copies, s32, t32, params, g_f, g_e
    torch.cuda.empty_cache()
    print(f"  ROADMAP C3, the same step on fp32 copies of the student and the teacher: loss "
          f"{loss_f:.6f} vs {loss_e:.6f} (rel {rel_loss:.3e}, tol {DISTILL_FP32_TOL['loss']:.0e}),"
          f" student gradient rel L2 {rel_grad:.3e} (tol {DISTILL_FP32_TOL['grad']:.0e})",
          flush=True)
    if not (rel_loss <= DISTILL_FP32_TOL["loss"] and rel_grad <= DISTILL_FP32_TOL["grad"]):
        fail("the fp32 distillation step with flash attention disagrees with einsum")
    return {"loss_rel": rel_loss, "grad_rel_l2": rel_grad}


def distill_step_plan(batch: int, k: int) -> dict:
    """Launches of one distillation step of round 0 (CFG folding): the two
    VAE encodes through K2; the teacher window's k UNet forwards at the CFG
    batch 2B without gradients (the flash forward, once each); the student's
    forward under remat (twice) and its backward. K3 for each GroupNorm32 of
    the encodes and of the teacher's forwards; the student's take the plain
    version."""
    teacher = {(16 * batch, 4096, 4096, 40): 5 * k, (16 * batch, 1024, 1024, 80): 5 * k}
    student = {(8 * batch, 4096, 4096, 40): 5, (8 * batch, 1024, 1024, 80): 5}
    k3 = scaled(vae_norms(VAEConfig(), batch, 512)[0], 2) + scaled(
        unet_norms(UNetConfig(), 2 * batch, 64), k)
    return {"self_attention_smalld": {}, "wide_attention": {(batch, 4096, 4096, 512): 2},
            "group_norm_silu": dict(k3),
            "flash_attention_fwd": {**teacher, **{s: 2 * c for s, c in student.items()}},
            "flash_bwd_dkv": student, "flash_bwd_dq": student}


def vae_step_plan() -> dict:
    """Launches of one VAE trainer step: the generator pass's encode and
    decode through FlashAttention (forward once each, the decoder's attention
    outside its remat), their backward; the discriminator pass's encode
    through K2 and its decode's flash forward, both without autograd, so K3
    for each of their GroupNorm32s. No K2 under autograd."""
    enc, dec = vae_norms(VAEConfig(), VAE_BATCH, VAE_SIZE)
    return {"self_attention_smalld": {}, "wide_attention": {VAE_WIDE: 1},
            "group_norm_silu": dict(enc + dec), "flash_attention_fwd": {VAE_WIDE: 3},
            "flash_bwd_dkv": {VAE_WIDE: 2}, "flash_bwd_dq": {VAE_WIDE: 2}}


def unused_cross_attention(name: str) -> bool:
    """The UNet tensors a one-token context leaves without a gradient: the
    cross-attention's query and key projections (its single key gets all the
    weight) and the norm before them."""
    return any(f".{k}." in name for k in ("attn2.to_q", "attn2.to_k", "norm2"))


def distill_tiny_reference(d: Path) -> dict:
    """cli.distill --tiny at 256 px, fp32, two rounds (50 -> [25, 5]), one
    step each, on the card and on the CPU port, from one --teacher-ckpt of
    seeded tiny towers (their zero-initialised layers re-randomised) and the
    same draws made on the host: the losses and the final student."""
    import reface_tpu_torch.diffusion.distill as PD

    teacher = FaceSwapper(tiny_swap_config(image_size=256), device="cpu")
    for i, m in enumerate(teacher.towers().values()):
        init_params(m, seed=40 + i, dezero=True)  # an output that depends on every layer
    save_swap_params(d / "tiny_teacher.pt", {n: m.state_dict()
                                             for n, m in teacher.towers().items()})
    del teacher
    orig = PD.make_distill_draws
    out = {}
    for dev in (DEV, "cpu"):
        g = torch.Generator().manual_seed(4)
        PD.make_distill_draws = lambda b, lat, cfg, device, generator=None: {
            k: v.to(device) for k, v in orig(b, lat, cfg, "cpu", g).items()}
        try:
            res, _ = run_driver(cli_distill.main, [
                "--out", str(d / f"tiny_{dev}"), "--tiny", "--device", dev, "--image-size",
                "256", "--batch-size", "2", "--target-steps", "5", "--steps-per-round", "1",
                "--log-every", "1", "--teacher-ckpt", str(d / "tiny_teacher.pt")])
        finally:
            PD.make_distill_draws = orig
        out[dev] = ([h["loss"] for h in res["history"]],
                    {k: v.float().cpu() for k, v in res["modules"].unet.state_dict().items()})
        del res
    (lc, wc), (lp, wp) = out[DEV], out["cpu"]
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    rel_w = rel_l2(wc, wp)
    print(f"  tiny 256 px cli.distill, two rounds (50 -> [25, 5]) of one step, card vs CPU "
          f"(fp32): losses {lc} vs {lp}, rel {rel_loss:.3e} (tol {TRAINER_TINY_TOL['loss']:.0e}); "
          f"the student's weights rel L2 {rel_w:.3e} (tol {TRAINER_TINY_TOL['weights']:.0e})",
          flush=True)
    if len(lc) != 2 or not (rel_loss <= TRAINER_TINY_TOL["loss"]
                            and rel_w <= TRAINER_TINY_TOL["weights"]):
        fail("the card's tiny distillation disagrees with the CPU port")
    return {"loss_rel": rel_loss, "weights_rel_l2": rel_w}


def distill_path(cpu_params: dict, d: Path, smi: str, gen) -> dict:
    """Phase 15 (a): cli.distill at full width from a --teacher-ckpt params
    file of phase 3's towers, on a CelebA-style tree; the student served by
    cli.swap; the tiny two-round run card vs CPU."""
    import reface_tpu_torch.diffusion.distill as PD

    cfg = SwapConfig()
    tree = d / "celeba"
    make_synthetic_celeba(str(tree), count=DISTILL_ITEMS, size=cfg.image_size, seed=15)
    save_swap_params(d / "teacher.pt", cpu_params)
    out_dir = d / "distill"
    teacher_seen = {}
    make_loss = PD.make_distill_loss

    def make_logged(*a, **kw):
        # the teacher the round starts with, kept to check that it stays
        loss_fn, tt, ts = make_loss(*a, **kw)

        def loss(student_fn, teacher_fn, *rest):
            if "module" not in teacher_seen:
                teacher_seen["module"] = teacher_fn
                teacher_seen["sd"] = {k: v.to("cpu", copy=True)
                                      for k, v in teacher_fn.state_dict().items()}
            return loss_fn(student_fn, teacher_fn, *rest)

        return loss, tt, ts

    argv = ["--out", str(out_dir), "--teacher-ckpt", str(d / "teacher.pt"), "--dataset-dir",
            str(tree), "--train-count", str(DISTILL_ITEMS), "--teacher-steps", "50",
            "--target-steps", "10", "--max-rounds", "1", "--steps-per-round",
            str(DISTILL_STEPS), "--batch-size", str(DISTILL_BATCH), "--image-size",
            str(cfg.image_size), "--teacher-dtype", "bfloat16", "--log-every", "1"]
    marks = []
    draws_fn = PD.make_distill_draws

    def marked(*a, **kw):
        # each step starts with its draws: the launches between two marks
        # are one step's
        marks.append({k.__name__: collections.Counter(k.shapes) for k in KERNELS})
        return draws_fn(*a, **kw)

    PD.make_distill_loss, PD.make_distill_draws = make_logged, marked
    reset_counts()  # the distillation run starts here
    got = {}
    try:
        with recorded_launches(got):
            res, text = run_driver(cli_distill.main, argv)
            torch.cuda.synchronize()
    finally:
        PD.make_distill_loss, PD.make_distill_draws = make_loss, draws_fn
    launches = counts()
    plan = distill_step_plan(DISTILL_BATCH, DISTILL_K)
    ends = marks[1:] + [{k: collections.Counter(v) for k, v in got.items()}]
    if len(marks) != DISTILL_STEPS or any(marks[0].values()):
        fail(f"cli.distill: {len(marks)} steps, launches before the first {marks[:1]}")
    for i, (m0, m1) in enumerate(zip(marks, ends)):
        check_plan(f"cli.distill step {i}", {k: dict(m1[k] - m0[k]) for k in m1}, plan)
    history = res["history"]
    if len(history) != DISTILL_STEPS or not all(math.isfinite(h["loss"]) for h in history):
        fail(f"cli.distill's losses: {history}")
    manifest = json.loads((out_dir / "manifest.json").read_text())
    want_manifest = {"ddim_steps": 10, "cfg_scale": 1.0, "teacher_steps": 50,
                     "teacher_cfg_scale": 3.0, "rounds": [10], "mode": "distilled"}
    if manifest != want_manifest or "--ddim-steps 10 --scale 1.0" not in text.splitlines()[-1]:
        fail(f"cli.distill's manifest {manifest} or last line {text.splitlines()[-1]}")

    # the student moved, the teacher and the frozen towers did not
    modules = res["modules"]
    start = cpu_params["unet"]
    student = modules.unet.state_dict()
    moved = {k for k, v in student.items() if not torch.equal(v.cpu(), start[k].float())}
    unused = {k for k in student if unused_cross_attention(k)}
    if moved != set(student) - unused:
        fail(f"student tensors that did not move {sorted(set(student) - unused - moved)[:6]} "
             f"or unused ones that did {sorted(moved & unused)[:6]}")
    teacher_same = all(torch.equal(v.cpu(), teacher_seen["sd"][k])
                       for k, v in teacher_seen["module"].state_dict().items())
    frozen_same = all(torch.equal(v.float().cpu(), cpu_params[name][k].float())
                      for name in ("vae", "conditioner")
                      for k, v in modules.towers()[name].state_dict().items())
    if not (teacher_same and frozen_same):
        fail(f"the teacher ({teacher_same}) or the frozen towers ({frozen_same}) changed")
    timing = read_jsonl(out_dir / "timing.jsonl")
    step_s = [r["step_s"] for r in timing]
    peak = max(r.get("peak_bytes_in_use", 0) for r in timing)
    print(f"  cli.distill ({smi}) --teacher-ckpt (phase 3's towers) --teacher-dtype bfloat16, "
          f"round 0 of 50 -> 10 at batch {DISTILL_BATCH}, {DISTILL_STEPS} steps: losses "
          f"{[round(h['loss'], 6) for h in history]}; {len(moved)} of {len(student)} student "
          f"tensors moved (the {len(unused)} a one-token context leaves without a gradient did "
          f"not), the teacher and the frozen towers bit-identical; step times "
          f"{[round(s, 3) for s in step_s]} s, peak {peak / 2**30:.2f} GiB; launches (K1, K2, "
          f"K3, K2r, K4, K5) {launches}, {DISTILL_STEPS} x the plan by shape; manifest "
          f"{manifest}", flush=True)
    stats = {"losses": [h["loss"] for h in history], "step_s": step_s,
             "steady_step_s": sum(step_s[1:]) / len(step_s[1:]), "peak_gib": peak / 2**30,
             "launches": dict(zip(("K1", "K2", "K3", "K2r", "K4", "K5"), launches)),
             "moved": len(moved), "unused": len(unused)}

    # the teacher window and one step, flash against einsum, and the teacher
    # window's share of a step by CUDA events
    ds = CelebAHQDataset(CelebAHQConfig(dataset_dir=str(tree), image_size=cfg.image_size,
                                        train_count=DISTILL_ITEMS, data_seed=0))
    raw = collate([ds[i] for i in range(DISTILL_BATCH)])
    batch = {"target_image": raw["GT"], "inpaint_image": raw["inpaint_image"],
             "inpaint_mask": raw["inpaint_mask"], "ref_clip224": raw["ref_imgs"]}
    dcfg = PD.DistillConfig(teacher_steps=50, student_steps=10)
    loss_fn, tt, _ = PD.make_distill_loss(dcfg, device=DEV)
    inputs = cli_distill.distill_inputs(modules, batch)
    draws = PD.make_distill_draws(DISTILL_BATCH, cfg.latent_size, dcfg, DEV, gen)
    teacher = res["teacher"]  # the round's end: a copy of the student
    params = list(modules.unet.parameters())

    def loss_and_grads():
        loss, _ = loss_fn(modules.unet, teacher, *inputs, draws)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.item(), {i: g.float() for i, g in enumerate(gs) if g is not None}

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    loss_f, g_f = loss_and_grads()  # warm
    z0, rest, c, uc = inputs
    a_t = tt.alphas[draws["i"] * DISTILL_K].reshape(-1, 1, 1, 1)
    x = torch.sqrt(a_t) * z0 + torch.sqrt(1 - a_t) * draws["noise"].permute(0, 3, 1, 2)
    window = lambda: PD.teacher_window(teacher, x, rest, draws["i"] * DISTILL_K, DISTILL_K,
                                       tt, c, uc, 3.0)
    ev[0].record()
    with torch.no_grad():
        end_f = window()
    ev[1].record()
    loss_f, g_f = loss_and_grads()
    ev[2].record()
    torch.cuda.synchronize()
    window_ms, step_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    # the teacher window alone, then the student's step with the teacher's
    # window held on the flash route (phase 7's comparison: one UNet forward
    # and backward)
    set_unet_attn(teacher, "einsum")
    with torch.no_grad():
        end_e = window()
    set_unet_attn(teacher, "flash")
    rel_window = float((end_f - end_e).double().norm() / end_e.double().norm())
    set_unet_attn(modules.unet, "einsum")
    before = counts()
    loss_e, g_e = loss_and_grads()
    ran = tuple(a - b for a, b in zip(counts(), before))
    set_unet_attn(modules.unet, "flash")
    rel_loss, rel_grad = abs(loss_f - loss_e) / abs(loss_e), rel_l2(g_f, g_e)
    print(f"  the teacher window (5 steps, CFG 3, batch 8), flash vs einsum (bf16): x_end rel "
          f"L2 {rel_window:.3e} (tol {DISTILL_TOL['window']:.0e}); one distillation step, the "
          f"student's attention flash vs einsum (the teacher's flash): loss {loss_f:.6f} vs "
          f"{loss_e:.6f} (rel {rel_loss:.3e}, tol {DISTILL_TOL['loss']:.0e}), student gradient "
          f"rel L2 {rel_grad:.3e} (tol {DISTILL_TOL['grad']:.0e}); launches in the einsum step "
          f"(K1, K2, K3, K2r, K4, K5) {ran} (the teacher's {10 * DISTILL_K} K2r and "
          f"{61 * DISTILL_K} K3 only); the "
          f"teacher window {window_ms:.1f} ms of a {step_ms:.1f} ms step "
          f"({100 * window_ms / step_ms:.1f}%)", flush=True)
    if ran != (0, 0, 61 * DISTILL_K, 10 * DISTILL_K, 0, 0) or not (
            rel_window <= DISTILL_TOL["window"] and rel_loss <= DISTILL_TOL["loss"]
            and rel_grad <= DISTILL_TOL["grad"]):
        fail("the distillation step with flash attention disagrees with einsum")
    stats.update(einsum={"loss_rel": rel_loss, "grad_rel_l2": rel_grad,
                         "teacher_window_rel_l2": rel_window},
                 teacher_window_ms=window_ms, step_ms=step_ms,
                 teacher_window_share=window_ms / step_ms)
    del g_f, g_e, end_f, end_e
    stats["einsum_fp32"] = distill_fp32_vs_einsum(modules.unet, teacher, loss_fn, inputs, draws)
    del res, modules, teacher, params, inputs, teacher_seen
    torch.cuda.empty_cache()

    # the student served: cli.swap --ckpt <out>/params.pt --ddim-steps 10
    # --scale 1.0 against FaceSwapper.swap on the same weights (bf16)
    params_file = out_dir / ckpt_io.PARAMS_FILE
    scfg = dataclasses.replace(cfg, ddim_steps=10, cfg_scale=1.0)
    direct = FaceSwapper(scfg, {n: sd for n, sd in ckpt_io.load_params(str(params_file)).items()},
                         device=DEV)
    cli_common._round_weights(direct.towers().values(), torch.bfloat16)
    images.imwrite(d / "source.png", photo_like(90, cfg.image_size, cfg.image_size))
    images.imwrite(d / "target.png", photo_like(91, cfg.image_size, cfg.image_size))
    src01 = cli_swap._read01(str(d / "source.png"))
    ref = clip_normalize(torch.from_numpy(src01[None]).to(DEV).permute(0, 3, 1, 2))
    tgt = cli_swap._read01(str(d / "target.png"), cfg.image_size)[None] * 2 - 1
    mask = cli_common.default_inpaint_mask(cfg.image_size)[None]
    want_img = direct.swap(target_image=tgt, inpaint_image=tgt * mask, inpaint_mask=mask,
                           ref_clip224=ref.permute(0, 2, 3, 1),
                           generator=torch.Generator(device=DEV).manual_seed(5))
    want_img = ((want_img[0].cpu() + 1) / 2).clamp(0, 1)
    del direct, ref
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    done = cli_swap.main(["--precropped", "--ckpt", str(params_file), "--ddim-steps", "10",
                          "--scale", "1.0", "--seed", "5", "--source", str(d / "source.png"),
                          "--target", str(d / "target.png"), "--outdir", str(d / "swapped")])
    serve_s = time.perf_counter() - t0
    got_img = images.imread(done[0][0])
    diff = (torch.from_numpy(got_img).float() / 255 - want_img).abs().max().item()
    served = counts()[:3]
    print(f"  cli.swap --precropped --ckpt <out>/params.pt --ddim-steps 10 --scale 1.0 (the "
          f"student, {params_file.stat().st_size / 2**30:.3f} GiB): within {diff * 255:.3f} "
          f"levels of FaceSwapper.swap on the same weights (limit 1), {serve_s:.1f} s with the "
          f"load; launches (K1, K2, K3) {served}", flush=True)
    if diff > LEVEL + 1e-6:
        fail(f"cli.swap on the distilled student is {diff * 255:.3f} levels off")
    stats.update(cli_swap_levels_from_direct=diff * 255, cli_swap_launches=served)
    stats["tiny_card_vs_cpu"] = distill_tiny_reference(d)
    return stats


@contextlib.contextmanager
def float64_cpu(*modules):
    """The modules in float64 for the block, their convs computing in it and
    every Tensor.float() of the port widened to float64: a CPU reference of
    an fp32 computation (the port's norms, LPIPS and discriminator compute
    through .float())."""
    orig = torch.Tensor.float
    for m in modules:
        m.double()
        for layer in m.modules():
            if hasattr(layer, "compute_dtype"):
                layer.compute_dtype = torch.float64
    torch.Tensor.float = lambda t: t.double() if t.is_floating_point() else orig(t)
    try:
        yield
    finally:
        torch.Tensor.float = orig


def vae_tiny_reference() -> dict:
    """One VAE trainer step at a tiny fp32 VAE whose mid-block is 512 wide
    (256 px, a 32 x 32 latent: the flash kernels at d = 512 over 1024
    tokens; remat as VAEConfig(remat=True)), the gate open, on the card, on
    the CPU port and on the CPU port in float64, from the same weights,
    batch and draws. The metrics, card against CPU, within 1e-5; the
    gradients of both updates held to the float64 ones: the card's within
    the larger of VAE_TINY_ABS and VAE_TINY_FP64 times the CPU port's fp32
    distance (fp32 rounding alone moves the first layers' gradients by up to
    ~1e-3)."""
    from reface_tpu_torch.diffusion import vae_loss as PL
    from reface_tpu_torch.nn.discriminator import NLayerDiscriminator

    vcfg = VAEConfig(ch=32, ch_mult=(1, 2, 4, 16), num_res_blocks=1, dtype=torch.float32,
                     remat=True)
    g = torch.Generator().manual_seed(8)
    x = torch.rand((2, 256, 256, 3), generator=g) * 2 - 1
    draws = PL.make_vae_draws(2, 32, "cpu", g)
    lp = init_params(LPIPS(), seed=9).state_dict()
    results = []
    sd = disc_sd = None
    for dev, dt in ((DEV, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        vae = AutoencoderKL(vcfg, device=dev, param_dtype=torch.float32)
        if sd is None:
            init_params(vae, seed=10, dezero=True)
            sd = {k: v.to("cpu", copy=True) for k, v in vae.state_dict().items()}
        vae.load_state_dict(sd)
        disc, lpips = NLayerDiscriminator(device=dev), LPIPS(device=dev)
        init_state, step_fn, _, _ = PL.make_vae_train_step(
            vae, PL.VAELossConfig(disc_start=0, kl_weight=1e-6, disc_weight=0.5),
            disc=disc, lpips=lpips)
        state = init_state(seed=11, disc_params=disc_sd)
        disc_sd = disc_sd or {k: v.to("cpu", copy=True) for k, v in disc.state_dict().items()}
        grads = {}
        for tower, opt in (("vae", state.opt_ae), ("disc", state.opt_disc)):
            def recording(gs, opt=opt, tower=tower, step=opt.step):
                grads.update({f"{tower}.{k}": gg.to("cpu", torch.float64, copy=True)
                              for k, gg in zip(opt.names, gs)})
                return step(gs)
            opt.step = recording
        lpips.load_state_dict(lp)
        wide = float64_cpu(vae, disc, lpips) if dt == torch.float64 else contextlib.nullcontext()
        reset_counts()
        with wide:
            _, m = step_fn(state, x.to(dev, dt), {k: v.to(dev, dt) for k, v in draws.items()},
                           lpips_params=lpips.state_dict())
        results.append(({k: v.item() for k, v in m.items()}, grads, counts()))
    (mc, gc, launched), (mp, gp, _), (_, g64, _) = results
    rel_m = max(abs(mc[k] - v) / max(abs(v), 1e-12) for k, v in mp.items() if v)
    total = sum(float(v.pow(2).sum()) for v in g64.values()) ** 0.5

    def worst(grads):
        return max((float((grads[k] - v).norm()) / max(float(v.norm()), 1e-3 * total), k)
                   for k, v in g64.items())

    (w_card, n_card), (w_cpu, n_cpu) = worst(gc), worst(gp)
    lim = max(VAE_TINY_ABS, VAE_TINY_FP64 * w_cpu)
    print(f"  tiny 256 px VAE trainer step (mid-block 512 wide), card vs CPU (fp32): metrics "
          f"rel {rel_m:.3e} (tol {TRAINER_TINY_TOL['loss']:.0e}); against the CPU port in "
          f"float64, worst gradient rel L2 over {len(g64)} tensors: the card {w_card:.3e} "
          f"({n_card}), the CPU port in fp32 {w_cpu:.3e} ({n_cpu}), limit {lim:.3e} (the "
          f"larger of {VAE_TINY_ABS:.0e} and {VAE_TINY_FP64}x the CPU's); "
          f"launches (K1, K2, K3, K2r, K4, K5) {launched}", flush=True)
    # K3: every GroupNorm32 of the discriminator pass, which runs without autograd
    enc, dec = vae_norms(vcfg, 2, 256)
    planned = (0, 1, sum((enc + dec).values()), 3, 2, 2)
    if launched != planned or not (rel_m <= TRAINER_TINY_TOL["loss"] and w_card <= lim):
        fail("the card's tiny VAE trainer step disagrees with the CPU port")
    return {"metrics_rel": rel_m, "grad_rel_l2_vs_fp64": w_card,
            "cpu_fp32_grad_rel_l2_vs_fp64": w_cpu, "limit": lim}


def vae_trainer_path(cpu_params: dict, d: Path, smi: str, gen) -> dict:
    """Phase 15 (b): cli.train_vae at VAEConfig() widths from a REFace-layout
    file of phase 3's VAE and a seeded LPIPS file, with the gate open and
    closed; one generator step against einsum; the tiny step card vs CPU."""
    from reface_tpu_torch.cli import train_vae as cli_train_vae
    from reface_tpu_torch.diffusion import vae_loss as PL

    imgs = d / "vae_images"
    imgs.mkdir()
    for i in range(VAE_IMAGES - 1):
        images.imwrite(imgs / f"{i}.png", photo_like(100 + i, 320, 300))
    (imgs / "upper.JPG").write_bytes(images.imencode(".jpg", photo_like(99, 400, 400)))
    torch.save({"state_dict": {**{VAE_PREFIX + k: v for k, v in cpu_params["vae"].items()},
                               UNET_PREFIX + "out.2.bias": cpu_params["unet"]["out.2.bias"]}},
               d / "sd.ckpt")
    torch.save(init_params(LPIPS(), seed=5).state_dict(), d / "lpips.pth")
    make = PL.make_vae_train_step
    stats = {}
    for run, gate, n_steps in (("gate_open", "0", 3), ("gated", "50001", 2)):
        snap, calls = {}, []

        def make_logged(*a, **kw):
            # the weights the first step starts from, and each step's launches
            init_state, step_fn, disc, lpips = make(*a, **kw)

            def init(*a2, **kw2):
                state = init_state(*a2, **kw2)
                snap.update({f"vae.{k}": v.to("cpu", copy=True)
                             for k, v in state.vae.state_dict().items()})
                snap.update({f"disc.{k}": v.to("cpu", copy=True)
                             for k, v in state.disc.state_dict().items()})
                return state

            def step(*a2, **kw2):
                got = {}
                with recorded_launches(got):
                    res = step_fn(*a2, **kw2)
                    torch.cuda.synchronize()
                calls.append(got)
                return res

            return init, step, disc, lpips

        out = d / f"vae_{run}"
        PL.make_vae_train_step = make_logged
        reset_counts()  # the VAE trainer's run starts here
        try:
            state, text = run_driver(cli_train_vae.main, [
                "--images", str(imgs), "--out", str(out), "--vae-ckpt", str(d / "sd.ckpt"),
                "--lpips-ckpt", str(d / "lpips.pth"), "--steps", str(n_steps),
                "--batch-size", str(VAE_BATCH), "--image-size", str(VAE_SIZE),
                "--disc-start", gate, "--log-every", "1"])
        finally:
            PL.make_vae_train_step = make
        launches = counts()
        for i, got in enumerate(calls):
            check_plan(f"cli.train_vae ({run}) step {i}", got, vae_step_plan())
        if len(calls) != n_steps or f"[vae] {VAE_IMAGES} images @ {VAE_SIZE}px" not in text \
                or "prefix=first_stage_model." not in text:
            fail(f"cli.train_vae ({run}): {len(calls)} steps, report {text[:400]}")
        rows = read_jsonl(out / "metrics.jsonl")
        if len(rows) != n_steps or not all(math.isfinite(v) for r in rows for v in r.values()):
            fail(f"cli.train_vae ({run}) metrics {rows}")
        d_w = [r["d_weight"] for r in rows]
        if (gate == "0") != all(w > 0 for w in d_w) or (gate != "0" and any(d_w)):
            fail(f"cli.train_vae ({run}): d_weight {d_w}")
        now = {f"vae.{k}": v.cpu() for k, v in state.vae.state_dict().items()}
        now.update({f"disc.{k}": v.cpu() for k, v in state.disc.state_dict().items()})
        moved = {k for k, v in now.items() if not torch.equal(v, snap[k])}
        want_moved = {k for k in now if gate == "0" or k.startswith("vae.")}
        if moved != want_moved:
            fail(f"cli.train_vae ({run}): tensors that did not move "
                 f"{sorted(want_moved - moved)[:6]} or that did {sorted(moved - want_moved)[:6]}")
        timing = read_jsonl(out / "timing.jsonl")
        step_s = [r["step_s"] for r in timing]
        peak = max(r.get("peak_bytes_in_use", 0) for r in timing)
        stats[run] = {"step_s": step_s, "steady_step_s": sum(step_s[1:]) / len(step_s[1:]),
                      "peak_gib": peak / 2**30, "d_weight": d_w,
                      "aeloss": [r["aeloss"] for r in rows],
                      "launches": dict(zip(("K1", "K2", "K3", "K2r", "K4", "K5"), launches))}
        print(f"  cli.train_vae ({smi}) --disc-start {gate}, VAEConfig() at {VAE_SIZE} px, "
              f"batch {VAE_BATCH}, {n_steps} steps (a .JPG among the {VAE_IMAGES} images): "
              f"aeloss {[round(r['aeloss'], 4) for r in rows]}, d_weight {d_w}; "
              f"{len(moved)} of {len(now)} tensors moved ({'both trees' if gate == '0' else 'the VAE; the discriminator at factor 0 did not'}); "
              f"step times {[round(s, 3) for s in step_s]} s, peak {peak / 2**30:.2f} GiB; "
              f"launches (K1, K2, K3, K2r, K4, K5) {launches}, each step as planned by shape",
              flush=True)
        if gate == "0":
            trained = state
        else:
            del state

    # one generator step, flash against einsum (the mid-block's attention)
    import reface_tpu_torch.nn.vae as VAE_MOD

    x = torch.from_numpy(cli_train_vae._load_images(str(imgs), VAE_SIZE)[:VAE_BATCH]).to(DEV)
    x = x.permute(0, 3, 1, 2).contiguous()
    eps = torch.randn((VAE_BATCH, 4, VAE_SIZE // 8, VAE_SIZE // 8), generator=gen, device=DEV)
    lpips = LPIPS(device=DEV).eval().requires_grad_(False)
    lpips.load_state_dict(torch.load(d / "lpips.pth", weights_only=True))
    lcfg = PL.VAELossConfig(disc_start=0, kl_weight=1e-6, disc_weight=0.5)
    params = list(trained.vae.parameters())

    def gen_grads():
        loss, aux = PL.generator_loss(trained.vae, trained.disc, lpips, x, eps, 1, lcfg)
        gs = torch.autograd.grad(loss, params)
        return loss.item(), aux["d_weight"].item(), {i: g.float() for i, g in enumerate(gs)}

    loss_f, dw_f, g_f = gen_grads()
    orig_mha = VAE_MOD.multi_head_attention
    VAE_MOD.multi_head_attention = lambda q, k, v, num_heads, impl="auto": orig_mha(
        q, k, v, num_heads, "einsum")
    before = counts()
    try:
        loss_e, dw_e, g_e = gen_grads()
    finally:
        VAE_MOD.multi_head_attention = orig_mha
    flash_runs = sum(counts()[1:]) - sum(before[1:])
    rel_loss, rel_grad = abs(loss_f - loss_e) / abs(loss_e), rel_l2(g_f, g_e)
    rel_dw = abs(dw_f - dw_e) / abs(dw_e)
    print(f"  one generator step (gate open), flash vs einsum at the mid-block (bf16): loss "
          f"{loss_f:.6f} vs {loss_e:.6f} (rel {rel_loss:.3e}, tol {TRAIN_TOL['loss']:.0e}), "
          f"d_weight rel {rel_dw:.3e}, VAE gradient rel L2 {rel_grad:.3e} (tol "
          f"{TRAIN_TOL['grad']:.0e}); K2/flash launches in the einsum run {flash_runs}",
          flush=True)
    if flash_runs or not (rel_loss <= TRAIN_TOL["loss"] and rel_grad <= TRAIN_TOL["grad"]
                          and rel_dw <= TRAIN_TOL["grad"]):
        fail("the VAE generator step with flash attention disagrees with einsum")
    stats["einsum"] = {"loss_rel": rel_loss, "grad_rel_l2": rel_grad, "d_weight_rel": rel_dw}
    del trained, params, g_f, g_e, lpips
    torch.cuda.empty_cache()
    stats["tiny_card_vs_cpu"] = vae_tiny_reference()
    return stats


def landmark_trainer_path(d: Path, smi: str) -> dict:
    """Phase 15 (c): cli.train_landmarks at LandmarkNetConfig(), 256 px, on
    faces make_landmark_faces drew; the file read back through
    build_raw_pipeline's --landmark-ckpt."""
    from types import SimpleNamespace

    from reface_tpu_torch.cli import train_landmarks as cli_train_landmarks
    from reface_tpu_torch.data import make_landmark_faces

    import numpy as np

    t0 = time.perf_counter()
    faces, lms = make_landmark_faces(LM_FACES, size=LM_SIZE, seed=16)
    faces_s = time.perf_counter() - t0
    np_path = d / "faces.npz"
    np.savez(np_path, images=faces, landmarks=lms)
    out = d / "lmnet.pt"
    reset_counts()
    t0 = time.perf_counter()
    net, text = run_driver(cli_train_landmarks.main, [
        "--data", str(np_path), "--out", str(out), "--steps", str(LM_STEPS), "--batch-size",
        str(LM_BATCH), "--lr", "3e-3", "--val-frac", "0.1", "--log-every", "50"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    l1 = [float(m) for m in re.findall(r"\[lm\] step \d+: L1 ([\d.]+) px", text)]
    err = float(re.search(rf"val mean px error vs labels @{LM_SIZE}px: ([\d.]+)", text).group(1))
    n_val = max(1, int(LM_FACES * 0.1))
    n_tr = LM_FACES - n_val
    base = float(np.sqrt(((lms[:n_tr].mean(0)[None] - lms[n_tr:]) ** 2).sum(-1)).mean())
    swapper = FaceSwapper(tiny_swap_config(64), device=DEV)
    pipe = cli_common.build_raw_pipeline(SimpleNamespace(landmark_ckpt=str(out)), swapper,
                                         RawPipelineConfig())
    saved = torch.load(out, weights_only=True)
    loaded = all(torch.equal(v, saved[k].to(v.device, v.dtype))
                 for k, v in pipe.landmark_net.state_dict().items())
    print(f"  cli.train_landmarks ({smi}) at LandmarkNetConfig(), {LM_SIZE} px: {LM_FACES} faces "
          f"drawn in {faces_s:.1f} s, {LM_STEPS} steps of batch {LM_BATCH} in {train_s:.1f} s "
          f"({LM_STEPS * LM_BATCH / train_s:.0f} faces/s); L1 {l1} px; held-out error {err:.2f} "
          f"px against the mean shape's {base:.2f} px; the file read back by "
          f"build_raw_pipeline's --landmark-ckpt: {loaded}; launches {counts()}", flush=True)
    if not (l1[-1] < l1[0] and err < base and loaded):
        fail("cli.train_landmarks did not converge below the mean shape or its file did not load")
    del net, pipe, swapper
    torch.cuda.empty_cache()
    return {"faces_s": faces_s, "train_s": train_s, "l1": l1, "val_px": err,
            "mean_shape_px": base}


def trainers_path(cpu_params: dict, smi: str, gen) -> dict:
    """Phase 15: the distillation, VAE and landmark trainers through their
    drivers, then K2, K2r, K4 and K5 at the shapes they add. Returns its
    stats; the files are deleted at the end."""
    d = Path(__file__).resolve().parent / "build" / "chip_smoke_trainers"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    stats = {}
    try:
        t0 = time.perf_counter()
        stats["distill"] = distill_path(cpu_params, d, smi, gen)
        stats["distill"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats["train_vae"] = vae_trainer_path(cpu_params, d, smi, gen)
        stats["train_vae"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats["train_landmarks"] = landmark_trainer_path(d, smi)
        stats["train_landmarks"]["wall_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"  K2 at the VAE trainer's {VAE_WIDE} encode, K2r, K4 and K5 there and at the "
          f"teacher's batch-8 shapes against their plain versions", flush=True)
    stats["k2"] = check_attention("K2", wide_attention, collections.Counter({VAE_WIDE: 1}), [],
                                  gen)
    shapes = [VAE_WIDE, *TEACHER_SHAPES]
    stats["kernels_worst"] = check_train_kernels(gen, shapes)
    stats["kernels"] = {key: {str(list(shape)): st for shape, st in by.items()}
                        for key, by in time_train_kernels(gen, shapes).items()}
    return stats


# ------------------------------------------------------------------ main

# ------------------------------------------------------------------ phase 16

# The video driver (cli.video_swap) at SwapConfig() and RawPipelineConfig()
# widths on phase 3's towers: an MJPEG AVI of VIDEO_FRAMES full-HD frames,
# swapped in the driver's batches of 10 at its DDIM-30, the last batch
# partial; the frames in VIDEO_NO_FACE hold no face (frame 0 passes
# through; 10 takes frame 9's swap across a batch edge, 15 takes 14's, 22
# takes 21's in the partial batch). Which frames hold a face is read from
# the frames (the faces are lit, the empty frames dark), as phase 10 forces
# its pattern: seeded random BiSeNet weights find no face to speak of.
VIDEO_FRAMES, VIDEO_BATCH, VIDEO_STEPS = 24, 10, 30
VIDEO_NO_FACE = (0, 10, 15, 22)
VIDEO_FPS = 25.0


def video_presence(self, target01, min_area_frac: float = 2e-3):
    return torch.as_tensor(target01).float().mean(dim=(1, 2, 3)) > 0.3


def write_video(path: Path) -> list:
    """VIDEO_FRAMES 1080 x 1920 frames: a photo-like background panning 8
    px a frame and, but in VIDEO_NO_FACE, a face of make_landmark_faces
    (the face template under a similarity, drawn at 256 px) blown up to
    960 px in the middle; the empty frames at a quarter of the light.
    Written as the port's MJPEG AVI; returns the frames as decoded."""
    from reface_tpu_torch.data import make_landmark_faces
    from reface_tpu_torch.io.video import VideoWriter, read_frames

    faces, _ = make_landmark_faces(VIDEO_FRAMES, size=256, seed=16)
    h, w = FRAME_HW
    bg = photo_like(160, h, w)
    s = 8 * h // 9
    top, left = (h - s) // 2, (w - s) // 2
    with VideoWriter(path, VIDEO_FPS) as out:
        for k in range(VIDEO_FRAMES):
            f = np.roll(bg, 8 * k, axis=1)
            if k in VIDEO_NO_FACE:
                f //= 4
            else:
                f[top: top + s, left: left + s] = images.resize_linear(faces[k], s, s)
            out.write(f)
    frames, fps = read_frames(path)
    lit = video_presence(None, torch.from_numpy(np.stack(frames)).float() / 255).tolist()
    if fps != VIDEO_FPS or len(frames) != VIDEO_FRAMES or [
            k for k, p in enumerate(lit) if not p] != list(VIDEO_NO_FACE):
        fail(f"the test video: {len(frames)} frames at {fps} fps, faces {lit}")
    return frames


def video_path(cpu_params: dict, smi: str) -> dict:
    """Phase 16: cli.video_swap on phase 3's towers against direct
    swap_images_robust calls. Returns its stats."""
    from reface_tpu_torch.cli import video_swap as cli_video

    cfg = dataclasses.replace(SwapConfig(), ddim_steps=VIDEO_STEPS)
    d = Path(__file__).resolve().parent / "build" / "chip_smoke_video"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    stats = {}
    try:
        paths = write_guidance_towers(d)
        save_swap_params(d / "params.pt", cpu_params)
        t0 = time.perf_counter()
        frames = write_video(d / "in.avi")
        images.imwrite(d / "source.png", photo_like(161, RAW_SIZE, RAW_SIZE))
        print(f"  wrote a {VIDEO_FRAMES}-frame {FRAME_HW[1]}x{FRAME_HW[0]} MJPEG AVI "
              f"({(d / 'in.avi').stat().st_size / 2**20:.1f} MiB) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out = d / "out"
        argv = ["--video", str(d / "in.avi"), "--source", str(d / "source.png"), "--outdir",
                str(out), "--ckpt", str(d / "params.pt"), "--bisenet-ckpt",
                str(paths["bisenet"]), "--landmark-ckpt", str(paths["landmarks"]), "--seed", "5",
                "--frames-dir", str(out / "frames"), "--bench-json"]
        batches = -(-VIDEO_FRAMES // VIDEO_BATCH)
        # 30 uniform DDIM steps are 31 timesteps (the reference's stride,
        # 1000 // 30 = 33, from 0 to 990): a batch runs 31 UNet forwards
        steps = len(DDIMTables.create(DiffusionSchedule.create(), VIDEO_STEPS, eta=cfg.eta,
                                      method=cfg.ddim_discretize).timesteps)
        one = guided_plan(dataclasses.replace(cfg, ddim_steps=steps), (), VIDEO_BATCH)
        plan = {k: {sh: c * batches for sh, c in v.items()} for k, v in one.items()}
        # LandmarkNet once for the source, then twice a batch (frames, crops)
        plan["group_norm_silu"] = dict(collections.Counter(plan["group_norm_silu"]) + scaled(
            landmark_norms(RawPipelineConfig().landmark, VIDEO_BATCH), 1 + 2 * batches))
        RawSwapPipeline.face_presence = video_presence
        try:
            reset_counts()  # the video path's run starts here
            torch.cuda.reset_peak_memory_stats()
            got = {}
            t0 = time.perf_counter()
            with recorded_launches(got):
                res = cli_video.main(argv)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = check_plan("cli.video_swap", got, plan)
            # the JAX driver's host-stage bypass: the frames decoded before
            # the clock, no writer (the codecs' share of a batch)
            got_ram = {}
            with recorded_launches(got_ram):
                ram = cli_video.main(argv[:argv.index("--frames-dir")] + ["--bench-ram"])
            check_plan("cli.video_swap --bench-ram", got_ram, plan)

            # the same video through swap_images_robust called directly: the
            # driver's swapper and pipeline, batches padded as it pads them
            args = cli_video.build_parser().parse_args(argv)
            args.ddim_steps = VIDEO_STEPS
            sw = cli_common.build_swapper(args)
            pipe = cli_common.build_raw_pipeline(args, sw, RawPipelineConfig())
            src = images.imread(d / "source.png").astype("float32")[None] / 255.0
            src_b = np.repeat(src, VIDEO_BATCH, axis=0)
            ref224 = pipe._source_reference(src_b)
            gen = torch.Generator(device=DEV).manual_seed(5)
            state, want, quads = None, [], []
            for i in range(0, VIDEO_FRAMES, VIDEO_BATCH):
                arr = np.stack(frames[i: i + VIDEO_BATCH]).astype("float32") / 255.0
                n = len(arr)
                arr = np.concatenate([arr, np.repeat(arr[-1:], VIDEO_BATCH - n, axis=0)])
                o, state, q = pipe.swap_images_robust(arr, src_b, generator=gen, state=state,
                                                      ref224=ref224)
                want += list(np.clip(o[:n].cpu().numpy() * 255.0, 0, 255).astype("uint8"))
                quads += list(q[:n])
            del sw, pipe, ref224, state
            torch.cuda.empty_cache()
        finally:
            del RawSwapPipeline.face_presence
        from reface_tpu_torch.io.video import read_frames

        outs, _ = read_frames(out / "frames")
        avi, avi_fps = read_frames(out / "swapped.avi")
        inv = np.load(out / "inv_transforms.npy")
        levels = max(int(np.abs(a.astype(int) - b).max()) for a, b in zip(outs, want))
        quad_err = float(np.abs(inv - np.stack(quads)).max())
        fallback = []
        for k in VIDEO_NO_FACE[1:]:  # each takes the frame before it
            kept = (outs[k - 1] == frames[k - 1]).all(-1)
            fallback.append(bool(np.array_equal(inv[k], inv[k - 1]) and 0 < kept.mean() < 1
                                 and np.array_equal(outs[k][kept], frames[k - 1][kept])))
        passed = bool(np.array_equal(outs[0], frames[0]))
        swapped = [k for k in range(VIDEO_FRAMES) if not np.array_equal(outs[k], frames[k])]
        ffmpeg = shutil.which("ffmpeg")
        mp4 = res["mp4"] and Path(res["mp4"]).stat().st_size
        bench = res["bench"]
        print(f"  {smi}: cli.video_swap, {VIDEO_FRAMES} frames {FRAME_HW[1]}x{FRAME_HW[0]} in "
              f"{batches} batches of {VIDEO_BATCH} (the last of {VIDEO_FRAMES % VIDEO_BATCH}), "
              f"DDIM-{VIDEO_STEPS}: {wall:.1f} s of wall with the loads, batches "
              f"{', '.join(f'{t:.2f}' for t in res['batch_s'])} s; steady "
              f"{bench['value']} frames/s ({bench['metric']}), {ram['bench']['value']} "
              f"frames/s with --bench-ram (batches "
              f"{', '.join(f'{t:.2f}' for t in ram['batch_s'])} s); peak {peak / 2**30:.2f} GiB; "
              f"launches {launches} (as planned by shape, {batches} x a batch-{VIDEO_BATCH} "
              f"swap of {steps} UNet forwards)", flush=True)
        print(f"  its frames within {levels} levels of direct swap_images_robust calls (limit "
              f"1), the quads within {quad_err:.2e} px; frame 0 passed through {passed}; the "
              f"frames without a face {list(VIDEO_NO_FACE[1:])} are their last good frame's "
              f"swap (its quad, its pixels outside the paste) {fallback}; swapped.avi "
              f"{len(avi)} frames at {avi_fps} fps; ffmpeg on the host: "
              f"{ffmpeg or 'no'}{f', swapped.mp4 {mp4} bytes' if ffmpeg else ''}", flush=True)
        if (levels > 1 or quad_err > 1e-3 or not passed or not all(fallback)
                or len(swapped) != VIDEO_FRAMES - 1 or len(avi) != VIDEO_FRAMES
                or avi_fps != VIDEO_FPS or res["frames"] != VIDEO_FRAMES
                or ram["frames"] != VIDEO_FRAMES or bench["value"] is None
                or ram["bench"]["value"] is None or (ffmpeg and not mp4)):
            fail("cli.video_swap: its output is not the direct swap_images_robust's, the "
                 "fallback or the pass-through is wrong, or a file is missing")
        stats = {"frames": VIDEO_FRAMES, "batch": VIDEO_BATCH, "ddim_steps": VIDEO_STEPS,
                 "wall_s_with_loads": wall, "batch_s": res["batch_s"],
                 "steady_frames_per_s": bench["value"], "bench_json": bench,
                 "bench_ram": ram["bench"], "bench_ram_batch_s": ram["batch_s"],
                 "peak_gib": peak / 2**30, "launches": launches, "levels_from_direct": levels,
                 "quad_max_err_px": quad_err, "fallback_ok": fallback, "ffmpeg": bool(ffmpeg),
                 "mp4_bytes": mp4 or None}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return stats


# ------------------------------------------------------------------ phase 17

# Phase 17, the parallel runtime (parallel/mesh.py, parallel/tp.py). (a) one
# process joins a world of one over NCCL; the mesh's step must be bit-equal
# to the plain one. (b) two processes share the one card over gloo (NCCL
# refuses two ranks on a device): a data-parallel and a tensor-parallel step
# against (a)'s one-process step, held to phase 7's limits (the per-rank
# batch and heads change the kernels' summation shapes, and the TP layers'
# rounding points): the loss, the UNet gradient, the clip's global norm and
# the change AdamW made to the UNet; and a TP UNet forward against the whole UNet, held to
# the bf16-against-fp32 limit of phase 4 (a bf16 forward whose rounding
# points moved). Their seconds are two ranks sharing one card, not a
# scaling figure.
PAR_BATCH = 4  # the one-process step's batch and the DP world batch
PAR_STEPS = 2
PAR_CLI_BATCH = 2
PAR_CLI_ITEMS, PAR_CLI_SIZE = 4, 512
# Every step at lr 100 (no warmup: the schedule holds learning_rate x 1e-6)
# behind a clip of 1e-9 that always engages, without weight decay. The
# clipped gradient's elements then lie below a tenth of Adam's eps (1e-8),
# where Adam's first update g / (|g| + eps) is g / eps to within 10 %: the
# change of the weights is the clipped gradient scaled by lr / eps, so it
# shows a shard skipped or updated twice and a wrong global norm, instead
# of the gradient's signs alone.
PAR_TCFG = TrainConfig(learning_rate=1e8, warmup_steps=0, weight_decay=0.0, grad_clip=1e-9)
# the per-rank TP shapes of K2r, K4 and K5 in a batch-4 step (4 of the 8
# heads a rank) and of K1 in a batch-2 forward with CFG dedup
TP_TRAIN_SHAPES = ((16, 4096, 4096, 40), (16, 1024, 1024, 80))
# the fp32 TP UNet forward against the whole fp32 UNet (TF32 off): only the
# summation order of the row-parallel products and the convs' split moves;
# expected near 1e-6 relative L2
TP_FP32_TOL = 1e-4


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def par_dir() -> Path:
    return Path(__file__).resolve().parent / "build" / "chip_smoke_parallel"


def par_inputs():
    """The batches and draws of phase 17's steps (global, PAR_BATCH rows),
    the same in every process on the card."""
    cfg = SwapConfig()
    batches = [make_request(300 + s, cfg.image_size, "cuda", batch=PAR_BATCH)
               for s in range(PAR_STEPS)]
    gen = torch.Generator(device="cuda").manual_seed(17)
    draws = [make_draws(PAR_BATCH, cfg.latent_size, PAR_TCFG, "cuda", gen)
             for _ in range(PAR_STEPS)]
    draws[0]["drop"][0] = True
    return batches, draws


def par_params() -> dict:
    """Seeded full-width training towers' state dicts (zero-initialised
    layers re-randomised), the same in every process on the card."""
    from reface_tpu_torch.pipelines.train import TrainModules

    m = TrainModules(SwapConfig(), "cuda")
    for i, t in enumerate(m.towers().values()):
        init_params(t, seed=i, dezero=True)
    return {n: t.state_dict() for n, t in m.towers().items()}


def timed_collectives() -> dict:
    """Wrap torch.distributed's collectives (what parallel/mesh.py calls) in
    a synchronised clock: {"s": seconds, "n": calls}."""
    import torch.distributed as dist

    stats = {"s": 0.0, "n": 0}
    for name in ("all_reduce", "all_gather", "broadcast"):
        def wrap(*a, _fn=getattr(dist, name), **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            stats["s"] += time.perf_counter() - t
            stats["n"] += 1
            return out
        setattr(dist, name, wrap)
    return stats


def par_steps(mesh, n: int, collectives=None, on_step=None, pre=None):
    """n steps of make_train_step(SwapConfig(), mesh=mesh) on this rank's
    rows of par_inputs(), cuDNN deterministic; pre(state, batches, draws)
    before them, on_step(s, state) after each. Returns (state, per step:
    loss, seconds, seconds in collectives, launches)."""
    from reface_tpu_torch.diffusion.ddim_guided import deterministic_cudnn

    step, _, init_state = make_train_step(SwapConfig(), PAR_TCFG, device="cuda", mesh=mesh)
    t0 = time.perf_counter()
    state = init_state(par_params())
    torch.cuda.synchronize()
    state.setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    batches, draws = par_inputs()
    if pre is not None:
        pre(state, batches, draws)
    b = PAR_BATCH // (1 if mesh is None else mesh.n_data)
    lo = 0 if mesh is None else mesh.data_rank * b
    out = []
    for s in range(n):
        local = {k: v[lo:lo + b] for k, v in batches[s].items()}
        c0 = dict(collectives or {"s": 0.0, "n": 0})
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with deterministic_cudnn():
            state, metrics = step(state, local, draws[s])
        torch.cuda.synchronize()
        state.last_loss = metrics["loss"].item()
        out.append({"loss": metrics["loss"].item(), "s": time.perf_counter() - t0,
                    "setup_s": state.setup_s,
                    "collective_s": (collectives or c0)["s"] - c0["s"],
                    "collectives": (collectives or c0)["n"] - c0["n"],
                    "launches": [x - y for x, y in zip(counts(), before)]})
        if on_step is not None:
            on_step(s, state)
    return state, out


def unet_state(state, grads: bool) -> dict:
    return {k: (p.grad if grads else p).detach().float().clone()
            for k, p in state.modules.unet.named_parameters()
            if not grads or p.grad is not None}


def clip_norm(state) -> float:
    """The global norm the optimizer's clip took of the step's gradients
    (under TP a collective over the model group: every rank calls it)."""
    opt = state.opt
    return float(opt._global_norm([torch.zeros_like(p) if p.grad is None else p.grad
                                   for p in opt.params]))


def nccl_world1(_rank, port: int, d: str):
    """Phase 17 (a), in a process of its own: the plain steps, cli.train
    without the flags, cli.train with --coordinator (a world of one over
    NCCL), then the mesh's steps; bit-equal each to its plain twin. Writes
    the plain step 0's loss, UNet gradient, clip norm and the change AdamW
    made to the UNet (phase 17 (b)'s reference) and the stats to d."""
    from reface_tpu_torch.diffusion.ddim_guided import deterministic_cudnn
    from reface_tpu_torch.parallel import create_mesh, init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = Path(d)
    stats = {}
    # the plain steps; step 0 kept as (b)'s reference
    before = {}

    def snap(state, *_):
        before.update(unet_state(state, False))

    def keep(s, state):
        if s == 0:
            after = unet_state(state, False)
            delta = {k: after[k] - v for k, v in before.items()}
            del after
            before.clear()
            rms = (sum(float(v.double().square().sum()) for v in delta.values())
                   / sum(v.numel() for v in delta.values())) ** 0.5
            torch.save({"loss": state.last_loss, "grad": unet_state(state, True),
                        "delta": delta, "delta_rms": rms, "norm": clip_norm(state)},
                       d / "ref.pt")
            del delta

    state, plain = par_steps(None, PAR_STEPS, on_step=keep, pre=snap)
    grads, params = unet_state(state, True), unet_state(state, False)
    del state
    torch.cuda.empty_cache()
    # cli.train without and with the flags
    argv = ["--dataset-dir", str(d / "celeba"), "--batch-size", str(PAR_CLI_BATCH),
            "--train-count", str(PAR_CLI_ITEMS), "--steps", "2", "--log-every", "1",
            "--warmup-steps", "1", "--no-final-ckpt", "--image-log-every", "1000"]
    cli_losses = {}
    for name, extra in (("plain", []), ("flags", ["--coordinator", f"127.0.0.1:{port}",
                                                  "--num-processes", "1",
                                                  "--process-id", "0"])):
        t0 = time.perf_counter()
        with deterministic_cudnn():
            cli_train.main(argv + extra + ["--logdir", str(d / f"cli_{name}")])
        torch.cuda.empty_cache()
        cli_losses[name] = [m["loss"] for m in read_jsonl(d / f"cli_{name}" / "metrics.jsonl")]
        stats[f"cli_{name}_s"] = time.perf_counter() - t0
    import torch.distributed as dist

    stats["backend"] = dist.get_backend()
    rank, world = init_distributed(f"127.0.0.1:{port}", 1, 0)  # already joined: the same
    mesh = create_mesh()
    collectives = timed_collectives()
    state, meshed = par_steps(mesh, PAR_STEPS, collectives)
    same = {"losses": [p["loss"] for p in plain] == [m["loss"] for m in meshed],
            "grad": all(torch.equal(g, p.grad.float()) for g, p in zip(
                grads.values(), (q for q in state.modules.unet.parameters()
                                 if q.grad is not None))),
            "params": all(torch.equal(v, p.float()) for v, p in zip(
                params.values(), state.modules.unet.parameters())),
            "cli": cli_losses["plain"] == cli_losses["flags"]}
    stats.update(world=(rank, world), plain=plain, meshed=meshed, cli_losses=cli_losses,
                 bit_equal=same)
    (d / "nccl_world1.json").write_text(json.dumps(stats))
    dist.destroy_process_group()


def tp_k1_plan(cfg: SwapConfig, n_model: int) -> dict:
    """K1 by (BH, N, D) in one batch-2 UNet forward with CFG dedup on each
    of n_model TP ranks: mode_plan's shapes with the heads split."""
    plan = mode_plan(cfg, 1)
    return {(bh // n_model, n, dd): c // plan["forwards"]
            for (bh, n, dd), c in plan["K1"].items() if c}


def gloo_two_ranks(rank: int, port: int, d: str):
    """Phase 17 (b), rank `rank` of two sharing cuda:0 over gloo: the DP
    step, the TP UNet forward and the TP step, each against its
    one-process twin (rank 0 compares); writes rank 0's stats to d."""
    from reface_tpu_torch.parallel import create_mesh, init_distributed
    from reface_tpu_torch.parallel.tp import gather_params_tp, shard_params_tp
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = Path(d)
    init_distributed(f"127.0.0.1:{port}", 2, rank, local_device="cuda:0", backend="gloo")
    collectives = timed_collectives()
    t_start = time.perf_counter()
    ref = torch.load(d / "ref.pt", weights_only=False) if rank == 0 else None
    stats = {}

    def held(name, loss, grad, norm, start, after):
        """The loss, the UNet gradient, the clip's norm and the UNet's change
        against (a)'s step 0."""
        rel_loss = abs(loss - ref["loss"]) / abs(ref["loss"])
        rel_grad = rel_l2({k: g.cuda() for k, g in grad.items()},
                          {k: g.cuda() for k, g in ref["grad"].items()})
        rel_norm = abs(norm - ref["norm"]) / ref["norm"]
        rel_delta = rel_l2({k: after[k].detach().float() - v for k, v in start.items()},
                           {k: v.cuda() for k, v in ref["delta"].items()})
        stats[name].update(rel_loss=rel_loss, rel_grad=rel_grad, norm=norm,
                           ref_norm=ref["norm"], rel_norm=rel_norm, rel_delta=rel_delta,
                           ref_delta_rms=ref["delta_rms"],
                           ok=rel_loss <= TRAIN_TOL["loss"] and rel_grad <= TRAIN_TOL["grad"]
                           and rel_norm <= TRAIN_TOL["grad"]
                           and rel_delta <= TRAIN_TOL["grad"])

    t_ref = time.perf_counter() - t_start

    # data parallel: 2 rows a rank; rank 0 first runs the one-process step
    # on each half of the batch (the same rows, draws and weights as the two
    # ranks'), whose mean the two ranks' step must give bit for bit
    # start: the UNet before the step (rank 0): the seeded par_params(), the
    # TP step's starting point too
    halves, start = {}, {}

    def by_halves(state, batches, draws):
        from reface_tpu_torch.diffusion.ddim_guided import deterministic_cudnn

        if rank:
            return
        start.update(unet_state(state, False))
        plain = make_train_step(SwapConfig(), PAR_TCFG, device="cuda")[0]
        h = PAR_BATCH // 2
        for lo in (0, h):
            with deterministic_cudnn():
                loss, _ = plain.loss_and_grads(
                    state.modules, {k: v[lo:lo + h] for k, v in batches[0].items()},
                    {k: v[lo:lo + h] for k, v in draws[0].items()})
            g = unet_state(state, True)
            halves["loss"] = loss if lo == 0 else (halves["loss"] + loss) / 2
            halves["grad"] = g if lo == 0 else {k: (halves["grad"][k] + v) / 2
                                                for k, v in g.items()}
            del g

    mesh = create_mesh()
    state, dp = par_steps(mesh, 1, collectives, pre=by_halves)
    stats["dp"] = dp[0]
    if rank == 0:
        held("dp", dp[0]["loss"], unet_state(state, True), clip_norm(state), start,
             dict(state.modules.unet.named_parameters()))
        g = unet_state(state, True)
        stats["dp"]["bit_equal_to_halves"] = (
            dp[0]["loss"] == halves["loss"].item() and g.keys() == halves["grad"].keys()
            and all(torch.equal(v, halves["grad"][k]) for k, v in g.items()))
        stats["dp"]["ok"] = stats["dp"]["ok"] and stats["dp"]["bit_equal_to_halves"]
        del g
    halves.clear()
    del state
    torch.cuda.empty_cache()

    # tensor parallel: the UNet forward (bf16, batch 2, CFG dedup)
    cfg = SwapConfig()
    tp_mesh = create_mesh(n_data=1, n_model=2)
    unet = UNetModel(cfg.unet, device="cuda").eval().requires_grad_(False)
    init_params(unet, seed=3, dezero=True)
    x, t, ctx = unet_inputs(cfg, 5, 2 * BATCH)
    with torch.no_grad():
        whole = unet(x, t, ctx, cfg_expand=True)
        shard_params_tp(unet, tp_mesh)
        self_attention_smalld.shapes = collections.Counter()
        before, c0 = counts(), dict(collectives)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        part = unet(x, t, ctx, cfg_expand=True)
        torch.cuda.synchronize()
    k1 = dict(self_attention_smalld.shapes)
    self_attention_smalld.shapes = None
    rel = float((part - whole).double().norm() / whole.double().norm())
    plan = tp_k1_plan(cfg, 2)
    stats["tp_forward"] = {
        "s": time.perf_counter() - t0, "collective_s": collectives["s"] - c0["s"],
        "collectives": collectives["n"] - c0["n"], "rel_l2": rel,
        "k1_shapes": {str(list(k)): v for k, v in k1.items()},
        "k1_plan": {str(list(k)): v for k, v in plan.items()},
        "launches": [a - b for a, b in zip(counts(), before)],
        "ok": rel <= TOWER_TOL["UNet"] and k1 == plan}
    del unet, whole, part
    # the same in fp32 (TF32 off): the function, rounding aside
    unet = UNetModel(dataclasses.replace(cfg.unet, dtype=torch.float32),
                     device="cuda").eval().requires_grad_(False)
    init_params(unet, seed=3, dezero=True)
    with torch.no_grad():
        whole = unet(x, t, ctx, cfg_expand=True)
        shard_params_tp(unet, tp_mesh)
        part = unet(x, t, ctx, cfg_expand=True)
    rel32 = float((part - whole).double().norm() / whole.double().norm())
    stats["tp_forward"]["rel_l2_fp32"] = rel32
    stats["tp_forward"]["ok"] = stats["tp_forward"]["ok"] and rel32 <= TP_FP32_TOL
    del unet, whole, part
    torch.cuda.empty_cache()

    # tensor parallel: one step at the whole batch on both ranks
    state, tp = par_steps(tp_mesh, 1, collectives)
    stats["tp"] = tp[0]
    grads = gather_params_tp(state.modules, tp_mesh, grads=True)
    params = gather_params_tp(state.modules, tp_mesh)
    norm = clip_norm(state)  # the model group's collective: both ranks
    if rank == 0:
        held("tp", tp[0]["loss"], {k: g for k, g in grads.items() if g is not None}, norm,
             start, params)
        stats["tp"]["sharded"] = sum(getattr(p, "tp_dim", None) is not None
                                     for p in state.modules.unet.parameters())
        stats["ref_load_s"] = t_ref
        (d / "gloo_two_ranks.json").write_text(json.dumps(stats))
    del state, grads, params
    start.clear()
    dist.barrier()
    dist.destroy_process_group()


def parallel_path(smi: str, gen) -> dict:
    """Phase 17: the parallel runtime on the one card; (a) and (b) above,
    each in processes of their own, then K1, K2r, K4 and K5 at the per-rank
    TP shapes against their plain versions. Returns its stats."""
    import torch.multiprocessing as mp

    d = par_dir()
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    make_synthetic_celeba(str(d / "celeba"), count=PAR_CLI_ITEMS, size=PAR_CLI_SIZE, seed=17)
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        mp.start_processes(nccl_world1, args=(free_port(), str(d)), nprocs=1, join=True,
                           start_method="spawn")
        a = json.loads((d / "nccl_world1.json").read_text())
        a["wall_s"] = time.perf_counter() - t0
        print(f"  (a) a world of one over {a['backend']} (rank, world {a['world']}): "
              f"{PAR_STEPS} eps-MSE steps at batch {PAR_BATCH}, losses "
              f"{[p['loss'] for p in a['plain']]} plain, {[m['loss'] for m in a['meshed']]} "
              f"with the mesh; step seconds {[round(p['s'], 3) for p in a['plain']]} plain, "
              f"{[round(m['s'], 3) for m in a['meshed']]} with the mesh, of which "
              f"{[round(m['collective_s'], 3) for m in a['meshed']]} s in "
              f"{[m['collectives'] for m in a['meshed']]} collectives; cli.train losses "
              f"{a['cli_losses']}; bit-equal {a['bit_equal']} ({a['wall_s']:.1f} s)",
              flush=True)
        if not all(a["bit_equal"].values()):
            fail(f"the world of one differs from the plain step: {a['bit_equal']}")
        t0 = time.perf_counter()
        mp.start_processes(gloo_two_ranks, args=(free_port(), str(d)), nprocs=2, join=True,
                           start_method="spawn")
        b = json.loads((d / "gloo_two_ranks.json").read_text())
        b["wall_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    label = f"two ranks sharing one card over gloo, {smi}: not a scaling figure"
    print(f"  (a) cli.train {a['cli_plain_s']:.1f} s without the flags, {a['cli_flags_s']:.1f} s "
          f"with them; (b) the reference loaded in {b['ref_load_s']:.1f} s, the towers set "
          f"up in {b['dp']['setup_s']:.1f} s (DP) and {b['tp']['setup_s']:.1f} s (TP), "
          f"{b['wall_s']:.1f} s in all", flush=True)
    for name, what in (("dp", "DP step (2 rows a rank)"),
                       ("tp", "TP step (the 4 rows, half the heads and channels a rank)")):
        st = b[name]
        print(f"  (b) {what}: loss {st['loss']:.6f} vs {a['plain'][0]['loss']:.6f} (rel "
              f"{st['rel_loss']:.3e}, tol {TRAIN_TOL['loss']:.0e}), UNet gradient rel L2 "
              f"{st['rel_grad']:.3e} (tol {TRAIN_TOL['grad']:.0e}), the clip's norm "
              f"{st['norm']:.6e} vs {st['ref_norm']:.6e} (rel {st['rel_norm']:.3e}, tol "
              f"{TRAIN_TOL['grad']:.0e}), the UNet's change by AdamW (RMS "
              f"{st['ref_delta_rms']:.3e} in the reference) rel L2 {st['rel_delta']:.3e} (tol "
              f"{TRAIN_TOL['grad']:.0e})"
              + (f", {st['sharded']} UNet tensors sharded" if name == "tp" else
                 f", bit-equal to the mean of the one-process step's two halves "
                 f"{st['bit_equal_to_halves']}")
              + f"; {st['s']:.3f} s, {st['collective_s']:.3f} s in {st['collectives']} "
              f"collectives ({label}); launches {st['launches']}", flush=True)
        if not st["ok"]:
            fail(f"the {what} disagrees with the one-process step")
    f = b["tp_forward"]
    print(f"  (b) TP UNet forward (bf16, batch {BATCH}, CFG dedup): rel L2 {f['rel_l2']:.3e} "
          f"against the whole UNet (tol {TOWER_TOL['UNet']:.0e}), in fp32 "
          f"{f['rel_l2_fp32']:.3e} (tol {TP_FP32_TOL:.0e}); K1 per rank "
          f"{f['k1_shapes']}, planned {f['k1_plan']}; {f['s']:.3f} s, "
          f"{f['collective_s']:.3f} s in {f['collectives']} collectives ({label})", flush=True)
    if not f["ok"]:
        fail("the TP UNet forward disagrees with the whole UNet or its K1 plan")
    print("  K1 at the per-rank TP shapes of a batch-2 forward against its plain version",
          flush=True)
    k1_entry = check_attention("K1", self_attention_smalld, collections.Counter(
        {(bh, n, n, dd): c for (bh, n, dd), c in tp_k1_plan(SwapConfig(), 2).items()}), [], gen)
    print("  K2r, K4 and K5 at the per-rank TP shapes of a batch-4 step", flush=True)
    worst = check_train_kernels(gen, TP_TRAIN_SHAPES)
    times = time_train_kernels(gen, TP_TRAIN_SHAPES)
    return {"nccl_world1": a, "gloo_two_ranks": b, "k1": k1_entry, "train_worst": worst,
            "train_times": times, "label": label}


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
          f"{dict(k1_shapes)}, K2 per swap {dict(k2_shapes)}, K3 per UNet forward "
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
                               (2, 1000, 1100, 256), (2, 1000, 1100, 160),
                               (8, 1000, 1100, 40), (4, 1000, 1100, 80)], gen),
        "K3": check_groupnorm(k3_shapes, gen),
    }
    entries["K3"]["unfused"] = check_groupnorm_unfused(gen)
    entries["K1"]["d160"] = time_k1_wide(gen)
    entries["K1"]["d160"]["unet_1024_launches"] = {
        str(k): v for k, v in unet_forward_1024(swapper, cfg).items()}

    print(f"phase 3: the main path, SwapConfig() at {cfg.image_size} px, DDIM-"
          f"{cfg.ddim_steps}, CFG {cfg.cfg_scale}, dedup, {REQUESTS} requests of "
          f"batch {BATCH}", flush=True)
    main_launches, lat, peak = serve(swapper, cfg, k1_per_fwd, k2_per_swap)

    print(f"phase 4: bf16 towers against fp32 copies, UNet with and without "
          f"fused_groupnorm, batch {BATCH}", flush=True)
    k3_launches = towers_vs_fp32(swapper, cfg, k3_per_fwd)
    params = {name: m.state_dict() for name, m in swapper.towers().items()}
    del swapper
    torch.cuda.empty_cache()

    print("phase 5: a small input against the CPU port", flush=True)
    tiny_reference()

    t9 = time.perf_counter()
    print(f"phase 9: the swap's other serving modes, SwapConfig() widths and phase 3's "
          f"weights, batch {BATCH}, one warm-up and one timed request each", flush=True)
    mode_stats, tiled_entries, int8_stats, tiny_modes, zero_tile = serving_modes(params, gen)
    torch.cuda.empty_cache()
    print(f"  phase 9 took {time.perf_counter() - t9:.1f} s of wall", flush=True)

    cpu_params = {n: {k: v.cpu() for k, v in sd.items()} for n, sd in params.items()}
    t10 = time.perf_counter()
    print(f"phase 10: the raw-image path (RawSwapPipeline), RawPipelineConfig() with phase "
          f"3's towers: swap_images at batch {BATCH} of {RAW_SIZE} px frames, "
          f"swap_images_robust on batches of {ROBUST_BATCH} {FRAME_HW[0]}x{FRAME_HW[1]} "
          f"frames, the tiny fp32 path card vs CPU", flush=True)
    raw_stats = raw_path(params)
    del params
    torch.cuda.empty_cache()
    raw_stats["wall_s"] = t10 = time.perf_counter() - t10
    print(f"  phase 10 took {t10:.1f} s of wall", flush=True)

    t11 = time.perf_counter()
    print(f"phase 11: the drivers on phase 3's towers at batch {DRIVER_BATCH}: a full-width "
          f"last.ckpt written and read back, cli.swap --precropped and raw, the demo server, "
          f"the host codecs, GEGLU erf against tanh", flush=True)
    driver_stats = drivers_path(cpu_params, smi)
    k1_b1, k2_b1 = batch_shapes(cfg, DRIVER_BATCH)
    print("  K1 and K2 at the batch-1 shapes (per UNet forward / per swap) against their "
          "plain versions", flush=True)
    b1_entries = {"K1": check_attention("K1", self_attention_smalld, k1_b1, [], gen),
                  "K2": check_attention("K2", wide_attention, k2_b1, [], gen)}
    torch.cuda.empty_cache()
    driver_stats["wall_s"] = t11 = time.perf_counter() - t11
    print(f"  phase 11 took {t11:.1f} s of wall", flush=True)

    t12 = time.perf_counter()
    print(f"phase 12: the reference's test bench on phase 3's towers: "
          f"cli.inference_test_bench at --n-samples {BENCH_BATCH} on {BENCH_PAIRS} CelebA-style "
          f"pairs and at {FFHQ_BATCH} on an FFHQ-style tree, cli.evaluate with CLIP-FID, ID "
          f"retrieval, pose and expression, the eval towers card vs CPU", flush=True)
    bench_stats = test_bench_path(cpu_params, smi)
    k1_b10, k2_b10 = batch_shapes(cfg, BENCH_BATCH)
    print(f"  K1 and K2 at the batch-{BENCH_BATCH} shapes (per UNet forward / per swap) against "
          "their plain versions", flush=True)
    b10_entries = {"K1": check_attention("K1", self_attention_smalld, k1_b10, [], gen),
                   "K2": check_attention("K2", wide_attention, k2_b10, [], gen)}
    torch.cuda.empty_cache()
    bench_stats["wall_s"] = t12 = time.perf_counter() - t12
    print(f"  phase 12 took {t12:.1f} s of wall", flush=True)

    t14 = time.perf_counter()
    print(f"phase 14: the gradient-guided swap and the priors on phase 3's towers: "
          f"swap_guided at batch {BATCH} (id; id, seg, exp), its step against einsum, the tiny "
          f"fp32 guided swap card vs CPU, cli.swap --guidance, make-priors (tps, dift) and the "
          f"prior-start test bench", flush=True)
    guided_stats = guided_path(cpu_params, smi, gen)
    torch.cuda.empty_cache()
    guided_stats["wall_s"] = t14 = time.perf_counter() - t14
    print(f"  phase 14 took {t14:.1f} s of wall", flush=True)

    t15 = time.perf_counter()
    print(f"phase 15: the remaining trainers on phase 3's towers: cli.distill at SwapConfig() "
          f"widths, batch {DISTILL_BATCH}, and the distilled student served by cli.swap; "
          f"cli.train_vae at VAEConfig() widths, {VAE_SIZE} px, batch {VAE_BATCH}, the gate "
          f"open and closed; cli.train_landmarks at LandmarkNetConfig(), {LM_SIZE} px; the tiny "
          f"fp32 trainers card vs CPU", flush=True)
    trainer_stats = trainers_path(cpu_params, smi, gen)
    torch.cuda.empty_cache()
    trainer_stats["wall_s"] = t15 = time.perf_counter() - t15
    print(f"  phase 15 took {t15:.1f} s of wall", flush=True)

    t16 = time.perf_counter()
    print(f"phase 16: the video driver on phase 3's towers: cli.video_swap over a "
          f"{VIDEO_FRAMES}-frame {FRAME_HW[1]}x{FRAME_HW[0]} MJPEG AVI in batches of "
          f"{VIDEO_BATCH}, DDIM-{VIDEO_STEPS}, against swap_images_robust called directly",
          flush=True)
    video_stats = video_path(cpu_params, smi)
    del cpu_params
    torch.cuda.empty_cache()
    video_stats["wall_s"] = t16 = time.perf_counter() - t16
    print(f"  phase 16 took {t16:.1f} s of wall", flush=True)

    print("phase 6: the training kernels against their plain versions on the card",
          flush=True)
    train_worst = check_train_kernels(gen, TRAIN_SHAPES + RAGGED_SHAPES)
    train_stats = time_train_kernels(gen, TRAIN_SHAPES)
    print("  the same kernels at the VAE decoder's head width, d = 512 (the split-depth "
          "bf16 forward of attention_fwd_sm90.cuh, bf16 K4 and K5 of "
          "attention_bwd_wide_sm90.cuh), and at d = 256", flush=True)
    wide_worst = check_train_kernels(gen, WIDE_SHAPES)
    wide_stats = time_train_kernels(gen, WIDE_SHAPES[1:2])
    print("  the same kernels at a 1024 px UNet's d = 160, padded to 256 by the wrappers",
          flush=True)
    d160_worst = check_train_kernels(gen, D160_SHAPES)
    d160_stats = time_train_kernels(gen, D160_SHAPES[:1])

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

    t13 = time.perf_counter()
    print(f"phase 13: the training entry point, cli.train at SwapConfig() widths and "
          f"{cfg.image_size} px: {CLI_STEPS} full-loss steps at batch {CLI_BATCH} with "
          f"validation, samples and checkpoints, a full resume, a bf16-accumulator step, an "
          f"eps-MSE run, cli.swap on the trained checkpoint, cli.prepare_data", flush=True)
    cli_stats = train_cli_path(smi, gen)
    print(f"  K2 at the trainer's batch-{CLI_BATCH} encode shape against its plain version",
          flush=True)
    b4_k2 = check_attention("K2", wide_attention,
                            collections.Counter({(CLI_BATCH, 4096, 4096, 512): 2}), [], gen)
    torch.cuda.empty_cache()
    cli_stats["wall_s"] = t13 = time.perf_counter() - t13
    print(f"  phase 13 took {t13:.1f} s of wall", flush=True)
    t17 = time.perf_counter()
    print("phase 17: the parallel runtime on the one card: a world of one over NCCL (the "
          "mesh's steps and cli.train --coordinator bit-equal to the plain ones), two ranks "
          "over gloo (a DP and a TP step against the one-process step, a TP UNet forward "
          "against the whole UNet), K1, K2r, K4 and K5 at the per-rank TP shapes", flush=True)
    par_stats = parallel_path(smi, gen)
    torch.cuda.empty_cache()
    par_stats["wall_s"] = t17 = time.perf_counter() - t17
    print(f"  phase 17 took {t17:.1f} s of wall", flush=True)
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
               "reface_tpu/ops/groupnorm.py:80", main_launches[2],
               f"{REQUESTS} requests of the main path: {k3_per_fwd} a UNet forward (the fused "
               f"copy's {k3_launches}, over {len(k3_shapes)} shapes), an encode's and a "
               f"decode's"),
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
    rows[2].update({k: entries["K3"][k] for k in (
        "device_ms", "host_us_per_call", "library_device_ms", "per_shape")})
    rows[0]["also_replaces"] = "reface_tpu/ops/attention_smalld.py:141"
    rows[0]["max_abs_err_vs_smalld_attention_plain"] = entries["K1"][
        "max_abs_err_vs_smalld_attention_plain"]
    rows[0]["d160"] = entries["K1"]["d160"]
    # phase 9: each kernel's launches in each serving mode's timed request,
    # and K1 / K2 at the 1024 px tiles' shapes
    for row, key in zip(rows[:3], ("K1", "K2", "K3")):
        row["launches_serving_modes"] = {m: st[key] for m, st in mode_stats.items()}
    # phase 10: each kernel's launches in the timed raw request (batch 2) and
    # in a robust batch (4 frames)
    for row, key in zip(rows[:3], ("K1", "K2", "K3")):
        row["launches_raw_path"] = {
            "swap_images batch 2": raw_stats["swap_images"]["launches"][key],
            **{f"swap_images_robust {m} batch {ROBUST_BATCH}": st["launches"][key]
               for m, st in raw_stats["robust"].items()}}
    # phase 11: each kernel's launches in each driver's run (batch 1), and
    # K1 / K2 at the batch-1 shapes
    for row, key in zip(rows[:3], ("K1", "K2", "K3")):
        row["launches_drivers"] = {name: driver_stats[name]["launches"][key] for name in (
            "cli_precropped", "cli_raw", "demo_server")}
    for row, key in zip(rows[:2], ("K1", "K2")):
        row["batch1"] = {k: b1_entries[key][k] for k in (
            "max_abs_err", "rel_l2_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
    # phase 12: each kernel's launches in the test bench's timed run (two
    # batches of 10) and the FFHQ run (one of 2), and K1 / K2 at the
    # batch-10 shapes
    for row, key in zip(rows[:3], ("K1", "K2", "K3")):
        row["launches_test_bench"] = {
            f"celeba batch {BENCH_BATCH} (2 batches)": bench_stats["celeba"]["launches"][key],
            f"ffhq batch {FFHQ_BATCH}": bench_stats["ffhq"]["launches"][key]}
    for row, key in zip(rows[:2], ("K1", "K2")):
        row[f"batch{BENCH_BATCH}"] = {k: b10_entries[key][k] for k in (
            "max_abs_err", "rel_l2_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
    for row, key in zip(rows[:2], ("K1", "K2")):
        row["tiles_1024"] = {k: tiled_entries[key][k] for k in (
            "max_abs_err", "rel_l2_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
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
               "K4": "reface_tpu_torch/csrc/attention_bwd_wide_sm90.cuh",
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
                             + ", ".join(f"{c}x(BH,N,M,D)={sh}" for sh, c in per_step.items()),
                     "d160": {"shape": D160_SHAPES[0], "max_abs_err": d160_worst[key]["bf16"],
                              "rel_l2_err": d160_worst[key]["rel"],
                              **d160_stats[key][D160_SHAPES[0]]}})
        if key == "K4":
            rows[-1]["alone_ms"] = total["alone_ms"]
            rows[-1]["shared_ds_launch"] = "counted in flash_bwd_dq_d512 (K5's call runs it)"
    for row, wide_row, idx in zip(rows[3:6], rows[6:9], (3, 4, 5)):  # K2r, K4, K5
        row["launches_full_loss_path"] = full_launches[idx] - wide_row["launches"]
    # phase 13: each wrapper's launches (at every shape: K2r, K4 and K5 with
    # their d=512 calls) in cli.train's run A (4 full-loss steps at batch 4,
    # two validations, one sample swap) and its eps-MSE run, and K2 at the
    # trainer's batch-4 shape
    for row, key in zip([rows[i] for i in (0, 1, 3, 4, 5)], ("K1", "K2", "K2r", "K4", "K5")):
        row["launches_train_cli"] = {run: st[key] for run, st in
                                     cli_stats["launches_train_cli"].items()}
    # phase 14: each wrapper's launches in the guided requests, the guided
    # drivers, make-priors and the prior-start test bench; K2r, K4 and K5 at
    # the guided decode's batch-2 shape
    guided_runs = {"swap_guided id": guided_stats["id"]["launches"],
                   "swap_guided id,seg,exp": guided_stats["id_seg_exp"]["launches"],
                   "cli.swap --guidance precropped": guided_stats["cli_precropped"]["launches"],
                   "cli.swap --guidance raw": guided_stats["cli_raw"]["launches"],
                   "make-priors dift": guided_stats["priors_dift"]["launches"],
                   "test bench --prior-dir": guided_stats["prior_bench"]["launches"]}
    for row, k in zip([rows[i] for i in (0, 1, 2, 6, 7, 8)], KERNELS):
        row["launches_guided"] = {run: got[k.__name__] for run, got in guided_runs.items()}
    for row, key in zip(rows[6:9], ("K2r", "K4", "K5")):
        st, w = guided_stats["kernels"][key], guided_stats["kernels_worst"][key]
        _, by = bound_ms(st["bytes"], st["ops"], "bf16", 0.0 if key == "K4" else st["exps"])
        row["guided_batch2"] = {"shape": [BATCH, 4096, 4096, 512], "max_abs_err": w["bf16"],
                                "rel_l2_err": w["rel"], "bound_by": by,
                                **{k: st[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")
                                   if k in st},
                                **{k: st[k] for k in ("library_device_ms", "alone_ms") if k in st}}
    # phase 15: each wrapper's launches in the trainers' runs (cli.distill's
    # 3 steps, cli.train_vae's 3 steps with the gate open and 2 with it
    # closed); K2 at the VAE trainer's encode, K2r, K4 and K5 at the teacher's
    # batch-8 shapes and at the VAE trainer's mid-block
    trainer_runs = {"cli.distill": trainer_stats["distill"]["launches"],
                    "cli.train_vae --disc-start 0": trainer_stats["train_vae"]["gate_open"]["launches"],
                    "cli.train_vae gated": trainer_stats["train_vae"]["gated"]["launches"]}
    for row, key in zip([rows[i] for i in (0, 1, 3, 4, 5)], ("K1", "K2", "K2r", "K4", "K5")):
        row["launches_trainers"] = {run: st[key] for run, st in trainer_runs.items()}
    rows[1]["vae_trainer_batch4"] = {"shape": list(VAE_WIDE), **{k: trainer_stats["k2"][k] for k in (
        "max_abs_err", "rel_l2_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
    for row_set, shapes, what in ((rows[3:6], TEACHER_SHAPES, "distill_teacher_batch8"),
                                  (rows[6:9], (VAE_WIDE,), "vae_trainer_batch4")):
        for row, key in zip(row_set, ("K2r", "K4", "K5")):
            w = trainer_stats["kernels_worst"][key]
            row[what] = {"max_abs_err_worst": w["bf16"], "rel_l2_err_worst": w["rel"]}
            for shape in shapes:
                st = trainer_stats["kernels"][key][str(list(shape))]
                _, by = bound_ms(st["bytes"], st["ops"], "bf16",
                                 0.0 if key == "K4" and shape[3] > 128 else st["exps"])
                row[what][str(list(shape))] = {"bound_by": by, **{k: st[k] for k in (
                    "ms", "plain_ms", "bound_ms", "library_ms", "library_device_ms", "alone_ms")
                    if k in st}}
    # phase 16: K1's and K2's launches in the video driver's run
    for row, k in zip(rows[:2], KERNELS[:2]):
        row["launches_video"] = {
            f"cli.video_swap {VIDEO_FRAMES} frames, batch {VIDEO_BATCH}, DDIM-{VIDEO_STEPS}":
            video_stats["launches"][k.__name__]}
    # phase 17: launches a rank in the parallel runs (rank 0), and the
    # kernels at the per-rank TP shapes
    gl = par_stats["gloo_two_ranks"]
    for row, idx in zip([rows[i] for i in (0, 1, 3, 4, 5)], (0, 1, 3, 4, 5)):
        row["launches_parallel"] = {
            "NCCL world of one, 2 steps": sum(m["launches"][idx]
                                              for m in par_stats["nccl_world1"]["meshed"]),
            "gloo DP step, rank 0": gl["dp"]["launches"][idx],
            "gloo TP step, rank 0": gl["tp"]["launches"][idx],
            "gloo TP UNet forward, rank 0": gl["tp_forward"]["launches"][idx]}
    rows[0]["tp_per_rank"] = {"shapes": gl["tp_forward"]["k1_plan"], **{
        k: par_stats["k1"][k] for k in ("max_abs_err", "rel_l2_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")}}
    for row, key in zip(rows[3:6], ("K2r", "K4", "K5")):
        w = par_stats["train_worst"][key]
        row["tp_per_rank"] = {"max_abs_err": w["bf16"], "rel_l2_err": w["rel"],
                              "max_abs_err_fp32": w["fp32"], **{
                                  str(list(sh)): par_stats["train_times"][key][sh]
                                  for sh in TP_TRAIN_SHAPES}}
    rows[1]["batch4"] = {k: b4_k2[k] for k in (
        "max_abs_err", "rel_l2_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    steady = lat[1:] or lat
    tsteady = step_times[1:]
    fsteady = full_times[1:]
    print(f"summary: {smi}; swap latency first {lat[0]:.3f} s, steady "
          f"{sum(steady) / len(steady):.3f} s, {BATCH * len(steady) / sum(steady):.3f} "
          f"swaps/s, peak {peak / 2**30:.2f} GiB; train step (batch {TRAIN_BATCH}) first "
          f"{step_times[0]:.3f} s, steady {sum(tsteady) / len(tsteady):.3f} s, peak "
          f"{train_peak / 2**30:.2f} GiB; full-loss step (batch {full_batch}) first "
          f"{full_times[0]:.3f} s, steady {sum(fsteady) / len(fsteady):.3f} s, peak "
          f"{full_peak / 2**30:.2f} GiB; raw request (batch {BATCH}, {RAW_SIZE} px) first "
          f"{raw_stats['swap_images']['first_s']:.3f} s, steady "
          f"{raw_stats['swap_images']['steady_s']:.3f} s, peak "
          f"{raw_stats['swap_images']['peak_gib']:.2f} GiB, phase 10 {raw_stats['wall_s']:.1f} s; "
          f"drivers (batch {DRIVER_BATCH}) cli.swap --precropped first "
          f"{driver_stats['cli_precropped']['first_s']:.3f} s, steady "
          f"{driver_stats['cli_precropped']['steady_s']:.3f} s, demo server first "
          f"{driver_stats['demo_server']['first_s']:.3f} s, steady "
          f"{driver_stats['demo_server']['steady_s']:.3f} s, phase 11 {driver_stats['wall_s']:.1f} s; "
          f"test bench (batch {BENCH_BATCH}) {bench_stats['celeba']['swaps_per_s']:.3f} swaps/s, "
          f"peak {bench_stats['celeba']['peak_gib']:.2f} GiB, phase 12 "
          f"{bench_stats['wall_s']:.1f} s; cli.train (batch {CLI_BATCH}) steady step "
          f"{cli_stats['run_a']['steady_step_s']:.3f} s, loader wait "
          f"{100 * cli_stats['run_a']['loader_wait_share']:.2f}%, peak "
          f"{cli_stats['run_a']['peak_gib']:.2f} GiB, phase 13 {cli_stats['wall_s']:.1f} s; "
          f"guided request (id, batch {BATCH}) {guided_stats['id']['timed_s']:.3f} s, peak "
          f"{guided_stats['id']['peak_gib']:.2f} GiB, (id, seg, exp) "
          f"{guided_stats['id_seg_exp']['s']:.3f} s, phase 14 {guided_stats['wall_s']:.1f} s; "
          f"cli.distill (batch {DISTILL_BATCH}) steady step "
          f"{trainer_stats['distill']['steady_step_s']:.3f} s, peak "
          f"{trainer_stats['distill']['peak_gib']:.2f} GiB, teacher window "
          f"{100 * trainer_stats['distill']['teacher_window_share']:.1f}%; cli.train_vae (batch "
          f"{VAE_BATCH}, {VAE_SIZE} px) steady step "
          f"{trainer_stats['train_vae']['gate_open']['steady_step_s']:.3f} s, peak "
          f"{trainer_stats['train_vae']['gate_open']['peak_gib']:.2f} GiB; cli.train_landmarks "
          f"{trainer_stats['train_landmarks']['val_px']:.2f} px held out (mean shape "
          f"{trainer_stats['train_landmarks']['mean_shape_px']:.2f}), phase 15 "
          f"{trainer_stats['wall_s']:.1f} s; cli.video_swap (batch {VIDEO_BATCH}, "
          f"DDIM-{VIDEO_STEPS}) {video_stats['steady_frames_per_s']} frames/s, peak "
          f"{video_stats['peak_gib']:.2f} GiB, phase 16 {video_stats['wall_s']:.1f} s; "
          f"parallel ({par_stats['label']}) DP step {gl['dp']['s']:.3f} s with "
          f"{gl['dp']['collective_s']:.3f} s in collectives, TP step {gl['tp']['s']:.3f} s with "
          f"{gl['tp']['collective_s']:.3f} s, phase 17 {par_stats['wall_s']:.1f} s; wall "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"serving_modes": mode_stats, "int8": int8_stats,
                      "tiny_card_vs_cpu": tiny_modes, "raw_path": raw_stats,
                      "zero_tile": zero_tile, "drivers": driver_stats,
                      "test_bench": bench_stats, "train_cli": cli_stats,
                      "guided": guided_stats, "trainers": trainer_stats,
                      "video": video_stats,
                      "parallel": {k: v for k, v in par_stats.items()
                                   if k not in ("k1", "train_times")}}),
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
