"""The port's image files (reface_tpu_torch/io/images.py and its C++,
native/image_codec.cpp) against cv2 and PIL, which the port does not use.

- PNG decode: every colour type at every bit depth it allows, every filter
  type (rows filtered at random by a writer of this file), plain and Adam7,
  read as colour and as gray, equal to cv2.imdecode pixel for pixel.
- Baseline JPEG decode: 4:4:4, 4:2:2, 4:2:0 (PIL's encoder), gray, restart
  markers (cv2's encoder) and an EXIF orientation, as colour and as gray,
  equal to cv2.imdecode pixel for pixel; a progressive file decodes (the
  progressive cases are tests/test_torch_port_jpeg_progressive.py's), one
  with a second frame header raises.
- Encoders: cv2 reads the port's PNG exactly; the port's quality-95 JPEG,
  decoded by cv2, is within 0.1 dB PSNR of cv2's own quality-95 file.
- resize_linear: cv2.resize INTER_LINEAR within one level on uint8 (cv2's
  vertical pass rounds differently in its SIMD body and its scalar tail)
  and within 1e-5 on float32, up and down.
"""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from test_torch_port_helpers import one_torch_thread

from reface_tpu_torch.io import images as I

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

RNG = np.random.default_rng(0)


def _smooth(h, w, c=3, seed=0):
    """A photo-like image: a bicubic blow-up of coarse noise plus grain."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((h // 8 + 2, w // 8 + 2, c)).astype(np.float32)
    x = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, c)
    return np.clip(x * 255 + rng.normal(0, 8, (h, w, c)), 0, 255).astype(np.uint8)


def _cv2(data, gray=False):
    out = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    assert out is not None
    return out if gray else I.bgr_to_rgb(out)


# ------------------------------------------------------------------ PNG

def _filter_row(kind, row, prev, bpp):
    a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp].astype(np.int32)])
    b = prev.astype(np.int32)
    c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp].astype(np.int32)])
    x = row.astype(np.int32)
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8)


def _pack(samples, depth):
    """(h, w*ch) samples -> (h, stride) bytes at `depth` bits."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(samples.shape[0], -1), axis=1)


def _png(samples, ctype, depth, interlace, palette=None):
    """A PNG of (h, w, ch) samples, each row filtered by a random type."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
               (1, 0, 2, 2), (0, 1, 1, 2)] if interlace else [(0, 0, 1, 1)])
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for r in rows:
            kind = int(RNG.integers(0, 5))
            raw += bytes([kind]) + _filter_row(kind, r, prev, bpp).tobytes()
            prev = r

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                            0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


_PNG_KINDS = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16), (4, 8), (4, 16),
                                                    (6, 8), (6, 16)] + \
             [(3, d) for d in (1, 2, 4, 8)]


@pytest.mark.parametrize("interlace", [0, 1], ids=["rows", "adam7"])
def test_png_decode_matches_cv2(interlace):
    """Every colour type and bit depth, every filter type, odd sizes (so
    that Adam7's passes have ragged and empty columns)."""
    h, w = 13, 19
    for ctype, depth in _PNG_KINDS:
        ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        samples = RNG.integers(0, 1 << depth, (h, w, ch))
        palette = None
        if ctype == 3:
            palette = RNG.integers(0, 256, ((1 << depth), 3), dtype=np.uint8)
        data = _png(samples, ctype, depth, interlace, palette)
        for gray in (False, True):
            want, got = _cv2(data, gray), I.imdecode(data, gray)
            np.testing.assert_array_equal(got, want, err_msg=f"{ctype}/{depth}/{gray}")
    # 16-bit samples keep their high byte: 0x01FF reads as 1
    one = _png(np.full((2, 2, 1), 0x01FF), 0, 16, interlace)
    assert (I.imdecode(one, gray=True) == 1).all()


def test_encoders_read_by_cv2():
    """cv2 reads the port's PNG exactly (RGB and gray); the port's q95
    JPEG is within 0.1 dB PSNR of cv2's q95 file of the same image."""
    img = _smooth(203, 317)
    np.testing.assert_array_equal(_cv2(I.imencode(".png", img)), img)
    np.testing.assert_array_equal(_cv2(I.imencode(".png", img[..., 1]), gray=True),
                                  img[..., 1])
    np.testing.assert_array_equal(I.imdecode(I.imencode(".png", img)), img)

    def psnr(a):
        return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - img) ** 2))

    ours = psnr(_cv2(I.imencode(".jpg", img)))
    ok, theirs = cv2.imencode(".jpg", I.rgb_to_bgr(img))
    theirs = psnr(_cv2(theirs.tobytes()))
    assert abs(ours - theirs) < 0.1, (ours, theirs)


# ------------------------------------------------------------------ JPEG

def _exif_orientation(value):
    ifd = struct.pack("<HHHIHH", 1, 0x0112, 3, 1, value, 0) + struct.pack("<I", 0)
    return b"Exif\x00\x00" + b"II*\x00" + struct.pack("<I", 8) + ifd


def _jpeg(mode, img):
    if mode == "restart":
        ok, enc = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 80,
                                                        cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
        data = enc.tobytes()
        assert b"\xff\xd0" in data and b"\xff\xdd" in data
        return data
    b = io.BytesIO()
    if mode == "gray":
        Image.fromarray(img[..., 0]).save(b, "JPEG", quality=90)
    elif mode == "exif6":
        Image.fromarray(img).save(b, "JPEG", quality=90, exif=_exif_orientation(6))
    else:
        sub = {"444": 0, "422": 1, "420": 2}[mode]
        Image.fromarray(img).save(b, "JPEG", quality=90, subsampling=sub)
    return b.getvalue()


@pytest.mark.parametrize("mode", ["444", "422", "420", "gray", "restart", "exif6"])
def test_jpeg_decode_matches_cv2(mode):
    """Sizes that are no multiple of the MCU, read as colour and as gray."""
    img = _smooth(67, 93, seed=1)
    data = _jpeg(mode, img)
    for gray in (False, True):
        want, got = _cv2(data, gray), I.imdecode(data, gray)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{mode} gray={gray}")
    if mode == "exif6":
        assert I.imdecode(data).shape == (93, 67, 3)


def _doubled_sof(data, at_end):
    """`data` with a second SOF0 of a larger frame: just after the first, or
    just before EOI (after the scan)."""
    i = data.index(b"\xff\xc0")
    n = struct.unpack(">H", data[i + 2:i + 4])[0]
    sof = bytearray(data[i:i + 2 + n])
    sof[5:9] = struct.pack(">HH", 512, 512)
    if at_end:
        assert data.endswith(b"\xff\xd9")
        return data[:-2] + bytes(sof) + b"\xff\xd9"
    return data[:i + 2 + n] + bytes(sof) + data[i + 2 + n:]


def test_progressive_or_malformed_jpeg_raises():
    """A progressive file decodes as cv2 decodes it; a file with a second,
    larger frame header is refused, as libjpeg refuses one before the scan
    (JERR_SOF_DUPLICATE); one after the scan, which libjpeg never reads,
    is refused too, so that nothing is written past the buffer sized from
    the first."""
    b = io.BytesIO()
    Image.fromarray(_smooth(40, 48)).save(b, "JPEG", progressive=True)
    assert b"\xff\xc2" in b.getvalue()
    np.testing.assert_array_equal(I.imdecode(b.getvalue()), _cv2(b.getvalue()))
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        I.imdecode(b"GIF89a")
    b = io.BytesIO()
    Image.fromarray(_smooth(16, 24)).save(b, "JPEG", quality=90)
    for at_end in (False, True):
        data = _doubled_sof(b.getvalue(), at_end)
        if not at_end:  # after the scan libjpeg has its image and reads no further
            assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
        for gray in (False, True):
            with pytest.raises(ValueError, match="corrupt JPEG"):
                I.imdecode(data, gray)


def test_resize_linear_matches_cv2():
    src = _smooth(100, 131)
    for h, w in ((512, 512), (30, 77), (700, 300), (50, 65)):
        want = cv2.resize(src, (w, h), interpolation=cv2.INTER_LINEAR)
        got = I.resize_linear(src, h, w)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want).max() <= 1, (h, w)
        f = src.astype(np.float32) / 255
        want = cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(I.resize_linear(f, h, w), want, atol=1e-5, rtol=0)
    gray = src[..., 0]
    want = cv2.resize(gray, (64, 64), interpolation=cv2.INTER_LINEAR)
    assert np.abs(I.resize_linear(gray, 64, 64).astype(int) - want).max() <= 1
