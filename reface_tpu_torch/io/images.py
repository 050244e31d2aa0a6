"""Image files without cv2 or PIL: PNG and baseline JPEG decode and encode,
cv2's INTER_LINEAR resize, and the colour-order helpers.

The JAX package's drivers read and write images with cv2
(reface_tpu/cli/swap.py:33-47, cli/common.py:291-327, cli/demo_server.py);
the machine that holds the card has neither cv2 nor PIL. This module gives
the same pixels:

- `imdecode` / `imread` return what `cv2.imdecode` / `cv2.imread` return
  with IMREAD_COLOR (alpha dropped, gray replicated, 16-bit samples shifted
  right by 8, EXIF orientation applied to JPEGs) or IMREAD_GRAYSCALE, but in
  RGB order: (H, W, 3) uint8, or (H, W) for gray.
  - PNG: every bit depth (1-16), colour type, filter and Adam7. The chunks
    are parsed and inflated here (zlib); the unfilter is C++. A colour PNG
    read as gray uses libpng's rgb_to_gray with cv2's 0.299/0.587 weights
    (no gAMA handling: a file with a gAMA chunk may differ by a level).
  - JPEG: baseline, extended-sequential and progressive Huffman (spectral
    selection and successive approximation), 8-bit, 4:4:4, 4:2:2, 4:2:0
    and gray, restart markers, with libjpeg's ISLOW IDCT, fancy upsampling
    and YCbCr tables (native/image_codec.cpp). Arithmetic-coded files raise
    ValueError (ROADMAP A9d).
- `imencode` / `imwrite` write PNG (8-bit, Sub-filtered rows, zlib level 1,
  cv2's default compression) and baseline JPEG at cv2's defaults (quality
  95, 4:2:0, the standard tables), chosen by the extension.
- `resize_linear` is `cv2.resize(..., interpolation=INTER_LINEAR)` on
  uint8 (cv2's 11-bit fixed point, within a level; bit-exact at an exact 2x
  shrink, where cv2 4 switches to INTER_AREA's (a+b+c+d+2)>>2) and float32;
  `resize_nearest` is INTER_NEAREST.
- The PIL reads of the evaluation protocol (reface_tpu/eval/protocol.py):
  `open_rgb` is `Image.open(p).convert("RGB")` (no EXIF orientation, a
  16-bit gray PNG clipped to 255), `to_gray_pil` is `convert("L")` and
  `resize_bicubic_pil` is `Image.resize(..., Image.BICUBIC)`.

The C++ is built by g++ at first use through native_ops.image_library();
nothing is built at import time.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

__all__ = ["imdecode", "imread", "imencode", "imwrite", "resize_linear",
           "resize_nearest", "rgb_to_bgr", "bgr_to_rgb", "open_rgb", "to_gray_pil",
           "resize_bicubic_pil", "resize_bilinear_pil"]

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_JPEG_ERRORS = {
    -1: "corrupt JPEG data",
    -3: "arithmetic-coded JPEG is not supported yet (ROADMAP A9d)",
    -4: "unsupported JPEG (lossless, hierarchical, 12-bit, CMYK or a "
        "sampling layout libjpeg would not upsample)",
    -5: "truncated JPEG",
}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
# libpng's rgb_to_gray coefficients for cv2's (0.299, 0.587), out of 32768
_GRAY_RC, _GRAY_GC = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_GRAY_BC = 32768 - _GRAY_RC - _GRAY_GC


def rgb_to_bgr(img: np.ndarray) -> np.ndarray:
    """Swap the channel order of an (..., 3) image (its own inverse)."""
    return np.ascontiguousarray(img[..., ::-1])


bgr_to_rgb = rgb_to_bgr


def _ptr(a):
    import ctypes

    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _lib():
    from reface_tpu_torch import native_ops

    return native_ops.image_library()


# ------------------------------------------------------------------ PNG

def _png_chunks(data: bytes):
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError("truncated PNG")
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG without IEND")


def _unfilter(raw: memoryview, h: int, stride: int, bpp: int) -> np.ndarray:
    src = np.frombuffer(raw, np.uint8)
    if src.size < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    src = np.ascontiguousarray(src[:h * (stride + 1)])
    out = np.empty((h, stride), np.uint8)
    if _lib().ic_png_unfilter(_ptr(src), h, stride, bpp, _ptr(out)) != 0:
        raise ValueError("PNG row with an unknown filter type")
    return out


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> (h, w, ch) samples (uint8, or uint16 at 16 bits)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2")[:, :w * ch].astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
        axis=2, dtype=np.uint8)
    return vals[:, :w * ch].reshape(h, w, ch)


def _png_decode(data: bytes, gray: bool, pil: bool = False) -> np.ndarray:
    ihdr, palette, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if ch is None or comp != 0 or filt != 0 or interlace > 1 or w == 0 or h == 0:
        raise ValueError(f"unsupported PNG header {ihdr}")
    if depth not in {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
                     6: (8, 16)}[ctype]:
        raise ValueError(f"PNG colour type {ctype} cannot have bit depth {depth}")
    raw = memoryview(zlib.decompress(b"".join(idat)))
    bpp = max(1, ch * depth // 8)
    if not interlace:
        stride = (w * ch * depth + 7) // 8
        img = _samples(_unfilter(raw, h, stride, bpp), w, ch, depth)
    else:
        img = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            stride = (pw * ch * depth + 7) // 8
            rows = _unfilter(raw[pos:], ph, stride, bpp)
            pos += ph * (stride + 1)
            img[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
    # libpng's transforms as cv2 sets them: palette -> RGB, gray below 8 bits
    # scaled to 8, alpha stripped, rgb_to_gray for a gray read of colour,
    # then 16 -> 8 bits by dropping the low byte (`pil`: PIL opens 16-bit
    # gray as "I;16", whose convert clips to 255)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = img[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index out of range")
        img = palette[idx]
    elif ctype in (0, 4) and depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    color = ctype in (2, 3, 6)
    img = img[..., :3] if color else img[..., :1]
    if gray and color:
        wide = img.astype(np.uint32)
        r, g, b = wide[..., 0], wide[..., 1], wide[..., 2]
        mix = _GRAY_RC * r + _GRAY_GC * g + _GRAY_BC * b
        mix = (mix + 16384) >> 15 if img.dtype == np.uint16 else mix >> 15
        same = (r == g) & (g == b)
        img = np.where(same, r, mix).astype(img.dtype)[..., None]
    if img.dtype == np.uint16 and pil and ctype == 0:
        img = np.minimum(img, 255).astype(np.uint8)
    elif img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if gray:
        return np.ascontiguousarray(img[..., 0])
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img)


def _png_encode(img: np.ndarray, level: int = 1) -> bytes:
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if ch not in (1, 3):
        raise ValueError(f"PNG encode takes gray or RGB images, got {img.shape}")
    rows = img.reshape(h, w * ch)
    filtered = np.empty((h, w * ch + 1), np.uint8)
    filtered[:, 0] = 1  # Sub
    filtered[:, 1:ch + 1] = rows[:, :ch]
    filtered[:, ch + 1:] = rows[:, ch:] - rows[:, :-ch]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0)
    return (_PNG_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
            + chunk(b"IEND", b""))


# ------------------------------------------------------------------ JPEG

def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ApplyExifOrientation (EXIF tag 0x0112, values 1-8)."""
    t = lambda a: a.swapaxes(0, 1)
    return {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
            4: lambda a: a[::-1], 5: t, 6: lambda a: t(a)[:, ::-1],
            7: lambda a: t(a)[::-1, ::-1], 8: lambda a: t(a)[::-1]}[orientation](img)


def _jpeg_decode(data: bytes, gray: bool, orient: bool = True) -> np.ndarray:
    import ctypes

    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    dims = [ctypes.c_int() for _ in range(4)]
    rc = lib.ic_jpeg_info(_ptr(buf), buf.size, *(ctypes.byref(d) for d in dims))
    if rc < 0:
        raise ValueError(_JPEG_ERRORS.get(rc, f"JPEG error {rc}"))
    h, w, _, orientation = (d.value for d in dims)
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    rc = lib.ic_jpeg_decode(_ptr(buf), buf.size, h, w, int(gray), _ptr(out))
    if rc < 0:
        raise ValueError(_JPEG_ERRORS.get(rc, f"JPEG error {rc}"))
    return np.ascontiguousarray(_orient(out, orientation) if orient else out)


def _jpeg_encode(img: np.ndarray, quality: int = 95) -> bytes:
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    img = np.ascontiguousarray(img, np.uint8)
    # a bound on the coded size: per block and component at most 16 + 11 bits
    # of DC and 63 x (16 + 10) bits of AC, doubled for 0xFF stuffing
    blocks = (-(-h // 16) * 2) * (-(-w // 16) * 2) * (1.5 if ch == 3 else 1)
    cap = int(blocks * 420) + 4096
    out = np.empty(cap, np.uint8)
    n = _lib().ic_jpeg_encode(_ptr(img), h, w, ch, int(quality), _ptr(out), cap)
    if n < 0:
        raise ValueError(f"JPEG encode failed ({n}) for an image of shape {img.shape}")
    return out[:n].tobytes()


# ------------------------------------------------------------------ files

def imdecode(data, gray: bool = False) -> np.ndarray:
    """PNG or JPEG bytes -> (H, W, 3) RGB uint8, or (H, W) when `gray`.
    Raises ValueError on other or broken data."""
    data = bytes(data)
    if data.startswith(_PNG_SIG):
        return _png_decode(data, gray)
    if data[:2] == b"\xff\xd8":
        return _jpeg_decode(data, gray)
    raise ValueError("not a PNG or JPEG file")


def imread(path, gray: bool = False) -> np.ndarray:
    """`imdecode` of a file's bytes."""
    with open(path, "rb") as f:
        return imdecode(f.read(), gray)


def open_rgb(path) -> np.ndarray:
    """`PIL.Image.open(path).convert("RGB")` as (H, W, 3) uint8: alpha
    dropped, gray replicated, a palette expanded, like `imread`, but with no
    EXIF orientation (PIL applies none) and a 16-bit gray PNG clipped to 255
    (PIL's "I;16" convert) where cv2 drops the low byte."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIG):
        return _png_decode(data, False, pil=True)
    if data[:2] == b"\xff\xd8":
        return _jpeg_decode(data, False, orient=False)
    raise ValueError(f"{path}: not a PNG or JPEG file")


def to_gray_pil(img: np.ndarray) -> np.ndarray:
    """PIL's convert("L") of an (H, W, 3) RGB uint8 image -> (H, W) uint8:
    (R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16. The weights sum to
    65536, so an L image read through `open_rgb` (replicated) comes back as
    it was, as convert("L") leaves it; a palette image's entries go through
    the same sum (PIL's p2l), and RGBA's alpha is not read (rgba2l). An
    (H, W) image is already L and comes back as a copy."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        return img.copy()
    wide = img.astype(np.uint32)
    r, g, b = wide[..., 0], wide[..., 1], wide[..., 2]
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def imencode(ext: str, img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) RGB or (H, W) gray uint8 -> the bytes of a ".png" or a
    ".jpg"/".jpeg" file (JPEG at `quality`, 4:2:0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"imencode takes uint8 (H, W[, C]) images, got {img.dtype} {img.shape}")
    ext = ext.lower()
    if ext == ".png":
        return _png_encode(np.ascontiguousarray(img))
    if ext in (".jpg", ".jpeg"):
        return _jpeg_encode(img, quality)
    raise ValueError(f"unsupported image extension {ext!r}")


def imwrite(path, img: np.ndarray, quality: int = 95) -> None:
    """Write an RGB or gray uint8 image, in the format its extension names."""
    data = imencode(os.path.splitext(str(path))[1], img, quality)
    with open(path, "wb") as f:
        f.write(data)


# ------------------------------------------------------------------ resize

def _nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2's INTER_NEAREST source index: min(floor(x / (dst / src)), src - 1)
    in double, with no half-pixel shift."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """`cv2.resize(img, (width, height), interpolation=INTER_NEAREST)` for an
    (H, W[, C]) image of any dtype."""
    img = np.asarray(img)
    sh, sw = img.shape[:2]
    return np.ascontiguousarray(img[_nearest_index(sh, height)][:, _nearest_index(sw, width)])


def _linear_taps(src: int, dst: int):
    """cv2's INTER_LINEAR source index and weight of each output position:
    half-pixel centres, clamped at the edges."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    frac = f - i
    low = i < 0
    frac[low], i[low] = 0.0, 0
    high = i >= src - 1
    frac[high], i[high] = 0.0, src - 1
    return i, np.minimum(i + 1, src - 1), frac


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """`cv2.resize(img, (width, height), interpolation=INTER_LINEAR)` for an
    (H, W[, C]) uint8 or float32 image. uint8 runs cv2's fixed point (11-bit
    weights, its SIMD rows' rounding); float32 runs in float32."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize_linear takes uint8 or float32, got {img.dtype}")
    sh, sw = img.shape[:2]
    x0, x1, fx = _linear_taps(sw, width)
    y0, y1, fy = _linear_taps(sh, height)
    if img.dtype == np.float32:
        ax = fx.reshape((1, -1) + (1,) * (img.ndim - 2))
        rows = img[:, x0] * (1 - ax) + img[:, x1] * ax
        ay = fy.reshape((-1,) + (1,) * (img.ndim - 1))
        return (rows[y0] * (1 - ay) + rows[y1] * ay).astype(np.float32)
    # cv2: each weight saturate_cast<short>(w * 2048) (round half to even),
    # rows as int32 sums, then the vertical pass as its SIMD form does it:
    # ((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16), rounded >> 2
    cx = np.rint(np.stack([1 - fx, fx]) * 2048).astype(np.int32)
    cy = np.rint(np.stack([1 - fy, fy]) * 2048).astype(np.int32)
    shp = (1, -1) + (1,) * (img.ndim - 2)
    wide = img.astype(np.int32)
    rows = wide[:, x0] * cx[0].reshape(shp) + wide[:, x1] * cx[1].reshape(shp)
    shp = (-1,) + (1,) * (img.ndim - 1)
    top = ((rows[y0] >> 4) * cy[0].reshape(shp)) >> 16
    bottom = ((rows[y1] >> 4) * cy[1].reshape(shp)) >> 16
    return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)


_PIL_BITS = 22  # PIL's PRECISION_BITS: 32 - 8 - 2


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic_filter (a = -0.5), in its operation order."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _pil_triangle(x: np.ndarray) -> np.ndarray:
    """PIL's bilinear_filter: 1 - |x| inside (-1, 1)."""
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


# PIL's filters with their support at scale 1
_PIL_FILTERS = {"bicubic": (_pil_bicubic, 2.0), "bilinear": (_pil_triangle, 1.0)}


def _pil_taps(src: int, dst: int, kind: str = "bicubic"):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for BICUBIC or
    BILINEAR: the source index and the 22-bit fixed-point weight of each tap
    of each output position. A shrink widens the support by the scale (PIL's
    antialias); weights are normalised in double, summed in tap order."""
    filt, base = _PIL_FILTERS[kind]
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = base * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(dst) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), src) - xmin
    taps = np.arange(ksize)
    w = filt(((taps[None] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w[taps[None] >= xmax[:, None]] = 0.0
    ww = np.zeros(dst)
    for t in range(ksize):
        ww = ww + w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    k = np.trunc(w * (1 << _PIL_BITS) + np.where(w < 0, -0.5, 0.5)).astype(np.int64)
    return np.minimum(xmin[:, None] + taps[None], src - 1), k


def _pil_pass(img: np.ndarray, axis: int, dst: int, kind: str = "bicubic") -> np.ndarray:
    """One of PIL's 8bpc resample passes along `axis` (0 rows, 1 columns):
    the taps summed in int32 (PIL's INT32) from a half, shifted down and
    clipped to uint8 (clip8)."""
    idx, k = _pil_taps(img.shape[axis], dst, kind)
    src = img.astype(np.int32)
    shape = [1] * img.ndim
    shape[axis] = dst
    acc = np.full(img.shape[:axis] + (dst,) + img.shape[axis + 1:], 1 << (_PIL_BITS - 1),
                  np.int32)
    for t in range(idx.shape[1]):
        acc += np.take(src, idx[:, t], axis=axis) * k[:, t].astype(np.int32).reshape(shape)
    return np.clip(acc >> _PIL_BITS, 0, 255).astype(np.uint8)


def _resize_pil(img: np.ndarray, height: int, width: int, kind: str) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_{kind}_pil takes uint8, got {img.dtype}")
    out = img.copy()
    if img.shape[1] != width:
        out = _pil_pass(out, 1, width, kind)
    if img.shape[0] != height:
        out = _pil_pass(out, 0, height, kind)
    return out


def resize_bicubic_pil(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """`Image.fromarray(img).resize((width, height), Image.BICUBIC)` for an
    (H, W[, C]) uint8 image: PIL's convolution resample, the horizontal pass
    and then the vertical, each clipped to uint8; an image already at the
    size comes back unchanged (a copy)."""
    return _resize_pil(img, height, width, "bicubic")


def resize_bilinear_pil(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """`Image.fromarray(img).resize((width, height), Image.BILINEAR)`: the
    same convolution resample with PIL's triangle filter, whose support
    scales with the shrink (antialiased, unlike resize_linear's cv2 rule)."""
    return _resize_pil(img, height, width, "bilinear")
