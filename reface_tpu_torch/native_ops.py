"""ctypes bindings for the host runtime library (port of
reface_tpu/native_ops.py).

`native/reface_native.cpp` is the JAX package's native/src/reface_native.cpp,
copied: OpenMP C++ for the host side of the raw path (bilinear resize and
coordinate-map warps, TPS grids, mask LUTs, uint8 normalisation) and the
ERT landmark cascade (dlib shape-predictor semantics, reface's own binary
format; tools/convert_dlib_sp.py converts a dlib .dat offline).

`native/image_codec.cpp` holds the image codecs of io/images.py (the PNG
unfilter, baseline JPEG decode and encode); `image_library()` loads it.

Each library is built with g++ at first use, with native/Makefile's flags,
into `build/torch_native/` at the repo root (listed in .gitignore), named by
a hash of the source and the flags: an edited source is rebuilt. A failed
build raises with g++'s output; nothing here falls back to another
implementation. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "build",
    "library_path",
    "image_library",
    "resize_bilinear",
    "remap_bilinear",
    "tps_grid",
    "mask_remap",
    "preserve_mask",
    "u8_to_pm1",
    "u8_to_clip",
    "ert_load",
    "ert_predict",
    "ert_predict_batch",
]

_SRC = Path(__file__).resolve().parent / "native" / "reface_native.cpp"
_IMAGE_SRC = Path(__file__).resolve().parent / "native" / "image_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_native"
_FLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall", "-std=c++17", "-shared"]
_lib = None
_image_lib = None
# one build and one load at a time: the data loader's threads reach both
# libraries at once on their first items
_LOCK = threading.RLock()


def library_path(src: Path | None = None) -> Path:
    """Where the library of `src` (default reface_native.cpp) lives, built
    or not."""
    src = src or _SRC
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(src.read_bytes())
    stem = "libreface_native" if src == _SRC else f"lib{src.stem}"
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def build(src: Path | None = None) -> Path:
    """Compile the library of `src` (default reface_native.cpp) unless it is
    built; returns its path. Raises RuntimeError with g++'s output if the
    build fails."""
    src = src or _SRC
    out = library_path(src)
    with _LOCK:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("native library build failed: g++ not found") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native library build failed (g++ exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out


def _load():
    with _LOCK:
        return _lib if _lib is not None else _bind()


def _bind():
    global _lib
    lib = ctypes.CDLL(str(build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rn_resize_bilinear.argtypes = [f32p] + [ctypes.c_int] * 3 + [f32p] + [ctypes.c_int] * 2
    lib.rn_resize_bilinear.restype = None
    lib.rn_remap_bilinear.argtypes = ([f32p] + [ctypes.c_int] * 3 + [f32p, f32p, f32p]
                                      + [ctypes.c_int] * 2)
    lib.rn_remap_bilinear.restype = None
    lib.rn_tps_grid.argtypes = [f32p, f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int]
    lib.rn_tps_grid.restype = ctypes.c_int
    lib.rn_mask_remap.argtypes = [i32p, ctypes.c_int, i32p, ctypes.c_int, i32p]
    lib.rn_mask_remap.restype = None
    lib.rn_preserve_mask.argtypes = [i32p, ctypes.c_int, i32p, ctypes.c_int, f32p]
    lib.rn_preserve_mask.restype = None
    lib.rn_u8_to_pm1.argtypes = [u8p, ctypes.c_int, f32p]
    lib.rn_u8_to_pm1.restype = None
    lib.rn_u8_to_clip.argtypes = [u8p, ctypes.c_int, f32p]
    lib.rn_u8_to_clip.restype = None
    lib.rn_ert_load.argtypes = [ctypes.c_char_p]
    lib.rn_ert_load.restype = ctypes.c_int
    lib.rn_ert_predict.argtypes = [u8p, ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 4 + [f32p]
    lib.rn_ert_predict.restype = ctypes.c_int
    lib.rn_ert_n_points.argtypes = []
    lib.rn_ert_n_points.restype = ctypes.c_int
    lib.rn_ert_predict_batch.argtypes = [u8p] + [ctypes.c_int] * 3 + [f32p, f32p]
    lib.rn_ert_predict_batch.restype = ctypes.c_int
    _lib = lib
    return lib


def image_library():
    """The image-codec library (native/image_codec.cpp), built at first use."""
    with _LOCK:
        return _image_lib if _image_lib is not None else _bind_image_library()


def _bind_image_library():
    global _image_lib
    lib = ctypes.CDLL(str(build(_IMAGE_SRC)))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.ic_png_unfilter.argtypes = [u8p] + [ctypes.c_int] * 3 + [u8p]
    lib.ic_png_unfilter.restype = ctypes.c_int
    lib.ic_jpeg_info.argtypes = [u8p, ctypes.c_long] + [i32p] * 4
    lib.ic_jpeg_info.restype = ctypes.c_int
    lib.ic_jpeg_decode.argtypes = [u8p, ctypes.c_long] + [ctypes.c_int] * 3 + [u8p]
    lib.ic_jpeg_decode.restype = ctypes.c_int
    lib.ic_jpeg_encode.argtypes = [u8p] + [ctypes.c_int] * 4 + [u8p, ctypes.c_long]
    lib.ic_jpeg_encode.restype = ctypes.c_long
    _image_lib = lib
    return lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _up(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize_bilinear(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """(H, W, C) float32 -> (dh, dw, C): half-pixel bilinear, edge clamp."""
    lib = _load()
    src = np.ascontiguousarray(src, np.float32)
    sh, sw, c = src.shape
    dst = np.empty((dh, dw, c), np.float32)
    lib.rn_resize_bilinear(_fp(src), sh, sw, c, _fp(dst), dh, dw)
    return dst


def remap_bilinear(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """Sample (H, W, C) float32 at the (dh, dw) float coordinate maps."""
    lib = _load()
    src = np.ascontiguousarray(src, np.float32)
    sh, sw, c = src.shape
    map_x = np.ascontiguousarray(map_x, np.float32)
    map_y = np.ascontiguousarray(map_y, np.float32)
    if map_x.shape != map_y.shape:
        raise ValueError(f"map shapes differ: {map_x.shape} vs {map_y.shape}")
    dh, dw = map_x.shape
    dst = np.empty((dh, dw, c), np.float32)
    lib.rn_remap_bilinear(_fp(src), sh, sw, c, _fp(map_x), _fp(map_y), _fp(dst), dh, dw)
    return dst


def tps_grid(ctrl: np.ndarray, warped: np.ndarray, h: int, w: int) -> np.ndarray:
    """The (h, w, 2) TPS sampling grid from (P, 2) control points to their
    warped positions."""
    lib = _load()
    ctrl = np.ascontiguousarray(ctrl, np.float32)
    warped = np.ascontiguousarray(warped, np.float32)
    if ctrl.shape != warped.shape:
        raise ValueError(f"control point shapes differ: {ctrl.shape} vs {warped.shape}")
    out = np.empty((h, w, 2), np.float32)
    rc = lib.rn_tps_grid(_fp(ctrl), _fp(warped), ctrl.shape[0], _fp(out), h, w)
    if rc != 0:
        raise RuntimeError(f"tps solve failed rc={rc}")
    return out


def mask_remap(mask: np.ndarray, lut: np.ndarray) -> np.ndarray:
    lib = _load()
    mask = np.ascontiguousarray(mask, np.int32)
    lut = np.ascontiguousarray(lut, np.int32)
    out = np.empty_like(mask)
    lib.rn_mask_remap(_ip(mask), mask.size, _ip(lut), lut.size, _ip(out))
    return out


def preserve_mask(mask: np.ndarray, classes) -> np.ndarray:
    lib = _load()
    mask = np.ascontiguousarray(mask, np.int32)
    cls = np.asarray(list(classes), np.int32)
    out = np.empty(mask.shape, np.float32)
    lib.rn_preserve_mask(_ip(mask), mask.size, _ip(cls), cls.size, _fp(out))
    return out


def u8_to_pm1(img: np.ndarray) -> np.ndarray:
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape, np.float32)
    lib.rn_u8_to_pm1(_up(img), img.size, _fp(out))
    return out


def u8_to_clip(img: np.ndarray) -> np.ndarray:
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    if img.shape[-1] != 3:
        raise ValueError(f"u8_to_clip takes (..., 3) images, got {img.shape}")
    out = np.empty(img.shape, np.float32)
    lib.rn_u8_to_clip(_up(img), img.size // 3, _fp(out))
    return out


def ert_load(path: str) -> None:
    lib = _load()
    rc = lib.rn_ert_load(str(path).encode())
    if rc != 0:
        raise RuntimeError(f"ert model load failed rc={rc}")


def _n_points(lib) -> int:
    n = lib.rn_ert_n_points()
    if n == 0:
        raise RuntimeError("no ERT model loaded")
    return n


def ert_predict_batch(grays: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """grays: (N, H, W) uint8; boxes: (N, 4). Returns (N, n_points, 2)."""
    lib = _load()
    grays = np.ascontiguousarray(grays, np.uint8)
    boxes = np.ascontiguousarray(boxes, np.float32)
    n, h, w = grays.shape
    if boxes.shape != (n, 4):
        raise ValueError(f"boxes must be ({n}, 4), got {boxes.shape}")
    out = np.empty((n, _n_points(lib), 2), np.float32)
    rc = lib.rn_ert_predict_batch(_up(grays), n, h, w, _fp(boxes), _fp(out))
    if rc != 0:
        raise RuntimeError(f"ert batch predict failed rc={rc}")
    return out


def ert_predict(gray: np.ndarray, box) -> np.ndarray:
    """gray: (H, W) uint8; box: (x0, y0, x1, y1). Returns (n_points, 2)."""
    lib = _load()
    gray = np.ascontiguousarray(gray, np.uint8)
    out = np.empty((_n_points(lib), 2), np.float32)
    rc = lib.rn_ert_predict(
        _up(gray), gray.shape[0], gray.shape[1],
        float(box[0]), float(box[1]), float(box[2]), float(box[3]), _fp(out),
    )
    if rc != 0:
        raise RuntimeError(f"ert predict failed rc={rc}")
    return out
