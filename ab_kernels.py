#!/usr/bin/env python3
"""A/B of design variants of a Hopper kernel against the port's own, on the card.

Run from the root of the repo on a machine with a CUDA card:

    python3 ab_kernels.py

Each variant is a list of textual patches to a header of
reface_tpu_torch/csrc/; the patched copy is compiled by nvcc (in parallel,
beside the port's own build) into a library of its own under build/ab/ with a
plain C entry point, and called through ctypes on the same inputs as the
port's kernel wrapper. For each shape it prints whether each variant's output
is bit-equal to the port's, and the times (CUDA events) in turns: the port's
kernel, each variant, then the same in reverse order. Nothing here is used by
the port.

The variants kept here are those of K5 at D <= 128 (flash_bwd_dq_sm90 of
csrc/attention_bwd_sm90.cuh) that PERF.md reports: the accumulators of S and
dP zeroed by hand before each tile instead of the first k-step's
scale-d = 0, and FlashAttention-3's ping-pong of the two consumer
warpgroups.
"""

from __future__ import annotations

import ctypes
import subprocess
import time
from pathlib import Path

import torch

from reface_tpu_torch.ops import attention as PA
from reface_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "reface_tpu_torch" / "csrc"
OUT = ROOT / "build" / "ab"
HEADER = "attention_bwd_sm90.cuh"
SHAPES = ((32, 4096, 4096, 40), (32, 1024, 1024, 80))  # K5's shapes in the eps-MSE step

_ZERO = """#pragma unroll
    for (int i = 0; i < kS; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
"""
_S = "WgmmaSS<kBK>::run(sc, desc_sw128(q_addr + qoff, 16, 1024), desc_sw128(k_addr + off, 16, 1024), "
_DP = "WgmmaSS<kBK>::run(dp, desc_sw128(do_addr + qoff, 16, 1024), desc_sw128(v_addr + off, 16, 1024), "
_WAIT = ("    const uint32_t v_addr = k_addr + C::kKVBytes;\n"
         "    mbar_wait(base + C::kFull + 8 * s, (j / kStages) & 1);\n")
_LOOP = """  mbar_wait(base + C::kQFull, 0);
  for (int j = 0; j < ntiles; ++j) {"""
_RS = """    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      WgmmaRS<64 * kBoxes>::run(dq_acc, pd[kk], desc_sw128(k_addr + kk * 16 * 128, C::kKVBox, 1024));
    wg_commit();
"""
VARIANTS = {
    # S and dP zeroed by hand before each tile, every k-step accumulating
    "zeroed": [(_WAIT, _ZERO + _WAIT), (_S + "ks > 0);", _S + "1);"),
               (_DP + "ks > 0);", _DP + "1);")],
    # the two warpgroups take turns to issue their products (named barrier
    # 2 + wg is this warpgroup's turn), as attention_fwd_sm90.cuh's forward
    "pingpong": [
        (_LOOP, """  auto turn_wait = [&] { asm volatile("bar.sync %0, 256;\\n" ::"r"(2 + wg) : "memory"); };
  auto turn_pass = [&](bool last) {
    if (!(last && wg == 1)) asm volatile("bar.arrive %0, 256;\\n" ::"r"(3 - wg) : "memory");
  };
  mbar_wait(base + C::kQFull, 0);
  if (wg == 1) turn_pass(false);
  for (int j = 0; j < ntiles; ++j) {"""),
        (_WAIT + "\n", _WAIT + "    turn_wait();\n"),
        (_DP + "ks > 0);\n    }\n    wg_commit();\n",
         _DP + "ks > 0);\n    }\n    wg_commit();\n    turn_pass(false);\n"),
        (_RS, "    turn_wait();\n" + _RS + "    turn_pass(j + 1 == ntiles);\n"),
    ],
}
SHIM = """#include "{header}"
extern "C" int ab_dq(const void* q, const void* k, const void* v, const void* lse,
                     const void* dout, const void* di, void* dq, int bh, int n, int m,
                     int d, float scale, void* stream) {{
  return reface::sm90::flash_bwd_dq_bf16(q, k, v, lse, dout, di, dq, bh, n, m, d, scale,
                                         static_cast<cudaStream_t>(stream));
}}
"""


def patched(patches) -> str:
    text = (CSRC / HEADER).read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"ab_kernels: a patch does not match {HEADER} once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    """{name: the C entry point} of every variant, built in parallel with
    the port's own library."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, patches in VARIANTS.items():
        (OUT / f"{name}.cuh").write_text(patched(patches))
        (OUT / f"{name}.cu").write_text(SHIM.format(header=f"{name}.cuh"))
        lib = OUT / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *kernels._FLAGS, f"-I{CSRC}", "-o", str(lib), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kernels.build(("attention_flash_bwd",))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill stores" in line or "C75" in line]
        print(f"  {name}: nvcc exit {proc.returncode}; " + "; ".join(regs), flush=True)
        if proc.returncode:
            raise SystemExit(log[-3000:])
        fn = ctypes.CDLL(str(lib)).ab_dq
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_ms(fn, iters: int = 30) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device: this script runs only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    t0 = time.perf_counter()
    fns = build_variants()
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for bh, n, m, d in SHAPES:
        scale = d**-0.5
        q, k, v, do = (torch.randn(bh, x, d, generator=gen, device="cuda", dtype=torch.bfloat16)
                       for x in (n, m, m, n))
        o, lse = PA.flash_attention_fwd(q, k, v, scale)
        di = PA.row_dot(o, do)
        runs = {"port": lambda: PA.flash_bwd_dq(q, k, v, lse, do, di, scale)}
        ref = runs["port"]()
        equal = {}
        for name, fn in fns.items():
            out = torch.empty_like(q)
            runs[name] = (lambda fn=fn, out=out: kernels.check(fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
                di.data_ptr(), out.data_ptr(), bh, n, m, d, scale,
                torch.cuda.current_stream().cuda_stream), name))
            runs[name]()
            torch.cuda.synchronize()
            equal[name] = torch.equal(out, ref)
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(time_ms(runs[name]))
        print(f"  K5 bf16 (BH,N,M,D)=({bh},{n},{m},{d}): bit-equal to the port's "
              f"{equal}; ms in turns " + ", ".join(
                  f"{name} {' / '.join(f'{t:.4f}' for t in ts)}" for name, ts in times.items()),
              flush=True)


if __name__ == "__main__":
    main()
