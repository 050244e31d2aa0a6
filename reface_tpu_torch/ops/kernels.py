"""Build and load the port's CUDA kernels (reface_tpu_torch/csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface and loaded with ctypes. Libraries go into
`build/torch_kernels/` at the repo root (listed in .gitignore), named by a
hash of their sources, so an edited source is rebuilt and an unchanged one
is reused. Nothing is built or loaded at import time: `library()` builds on
first use, and `build()` builds several sources at once, one nvcc process
each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "SOURCES", "DTYPE_CODE", "BUILD_SECONDS", "build", "library",
           "library_path", "check", "count_launch", "refuse_grad"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("attention_smalld", "attention_wide", "attention_flash_bwd",
           "attention_flash_bwd_wide", "groupnorm")
_HEADERS = ("common.cuh", "attention_common.cuh", "attention_flash_bwd.cuh",
            "attention_fwd_sm90.cuh", "attention_bwd_sm90.cuh",
            "attention_bwd_wide_sm90.cuh", "wgmma_sm90.cuh")
# the `dtype` argument of every C entry point; other dtypes are refused
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "attention_smalld": {
        "reface_smalld_attention": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    },
    "attention_wide": {
        "reface_wide_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
        "reface_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    },
    "attention_flash_bwd": {
        "reface_flash_bwd_dkv": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
        "reface_flash_bwd_dq": [_P] * 7 + [_I] * 4 + [_F, _I, _P],
    },
    "attention_flash_bwd_wide": {
        "reface_flash_bwd_dkv_wide": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
        "reface_flash_bwd_dq_wide": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
    },
    "groupnorm": {
        "reface_group_norm_partials": [_I, _I, _I],
        "reface_group_norm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
# nvcc's wall time for each source built by this process
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where the built library for csrc/<name>.cu lives (built or not)."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in (f"{name}.cu",) + _HEADERS:
        h.update((_CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile the named sources that are not built yet, in parallel.

    Returns {name: nvcc's ptxas report} for the sources built by this call;
    raises RuntimeError with nvcc's output if any build fails.
    """
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        # nvcc's output goes to a file, not a pipe: nothing blocks on a full buffer
        log = open(out.with_suffix(f".{os.getpid()}.log"), "w+")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, tmp, out)
    reports, failed = {}, []
    while len(reports) < len(procs):
        for name, (proc, log, tmp, out) in procs.items():
            if name in reports or proc.poll() is None:
                continue
            BUILD_SECONDS[name] = time.perf_counter() - t0
            log.seek(0)
            reports[name] = text = log.read()
            log.close()
            os.remove(log.name)
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{text}")
            else:
                os.replace(tmp, out)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def refuse_grad(what: str, route: str, *tensors) -> None:
    """Raise where autograd would need a gradient through a kernel that has
    none: its output would come back detached and the gradient into its
    inputs would be silently zero. `route` names the differentiable way."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward, and an input "
                           f"requires grad; {route}")


def count_launch(wrapper, shape: tuple) -> None:
    """Add one to `wrapper.launches`, called where the wrapper launches its
    kernel. While `wrapper.shapes` is a Counter (chip_smoke.py sets one to
    survey a path), the call's shape is counted there too."""
    wrapper.launches += 1
    if wrapper.shapes is not None:
        wrapper.shapes[shape] += 1

