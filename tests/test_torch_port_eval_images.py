"""The PIL and cv2 reads of the evaluation protocol and the test bench
(reface_tpu_torch/io/images.py) against PIL and cv2 themselves:

- resize_bicubic_pil: Image.resize(..., BICUBIC) bit for bit (PIL's 22-bit
  fixed-point taps, its antialiased shrink, a pass clipped per axis), at
  the protocol's shapes, an upscale, a non-square image and the no-op;
- open_rgb and to_gray_pil: convert("RGB") and convert("L") on L, RGB,
  RGBA, P and LA PNGs, bit for bit; a JPEG with an EXIF orientation tag
  read as PIL reads it (not rotated), where imread rotates as cv2 does;
- resize_nearest: cv2's INTER_NEAREST, bit for bit, uint8 and float32;
- resize_linear at the exact 2x shrink (CelebA's 1024 -> 512): bit for bit
  on uint8, where cv2 4 takes INTER_AREA's (a+b+c+d+2)>>2 and cv2 5 the
  lerp, both the same sums; float32 within 1e-6 of cv2 and of INTER_AREA's
  ((a+b)+(c+d))/4 (one float32 ulp: the three round the average
  differently).
"""

import cv2
import numpy as np
import pytest
from PIL import Image

from test_torch_port_helpers import one_torch_thread

from reface_tpu_torch.io import images as I

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _photo(h, w, seed=0):
    """A photo-like uint8 image: a bicubic blow-up of coarse noise plus grain."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((h // 16 + 2, w // 16 + 2, 3)).astype(np.float32)
    x = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(x * 255 + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((1024, 1024), (224, 224)),    # clip_fid_load of a CelebA-HQ image
    ((512, 512), (224, 224)),      # clip_fid_load of a swap
    ((1024, 1024), (512, 512)),    # expression_load of a CelebA-HQ target
    ((100, 131), (300, 257)),      # an upscale
    ((1024, 1365), (224, 299)),    # a non-square image, shorter edge to 224
    ((512, 512), (512, 512)),      # the same size: returned unchanged
], ids=["1024-224", "512-224", "1024-512", "upscale", "non-square", "same-size"])
def test_resize_bicubic_pil_matches_pil(src_hw, dst_hw):
    img = _photo(*src_hw, seed=sum(src_hw))
    want = np.asarray(Image.fromarray(img).resize(dst_hw[::-1], Image.BICUBIC))
    got = I.resize_bicubic_pil(img, *dst_hw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if src_hw == dst_hw:
        np.testing.assert_array_equal(got, img)
        assert got is not img


def test_open_rgb_and_to_gray_pil_match_convert(tmp_path):
    rgb = _photo(48, 72, seed=1)
    alpha = np.random.default_rng(2).integers(0, 256, (48, 72, 1), np.uint8)
    images = {
        "L": Image.fromarray(rgb).convert("L"),
        "RGB": Image.fromarray(rgb),
        "RGBA": Image.fromarray(np.concatenate([rgb, alpha], axis=-1)),
        "P": Image.fromarray(rgb).quantize(37),
        "LA": Image.fromarray(rgb).convert("LA"),
    }
    for mode, im in images.items():
        p = tmp_path / f"{mode}.png"
        im.save(p)
        with Image.open(p) as f:
            assert f.mode == mode
            want_rgb, want_l = np.asarray(f.convert("RGB")), np.asarray(f.convert("L"))
        got = I.open_rgb(p)
        np.testing.assert_array_equal(got, want_rgb, err_msg=mode)
        np.testing.assert_array_equal(I.to_gray_pil(got), want_l, err_msg=mode)
        np.testing.assert_array_equal(I.to_gray_pil(want_l), want_l, err_msg=mode)
    # a 16-bit gray PNG: PIL's "I;16" converts by clipping to 255, where cv2
    # (and imread) drop the low byte
    p = tmp_path / "I16.png"
    cv2.imwrite(str(p), (np.arange(48 * 72, dtype=np.uint16) * 19).reshape(48, 72))
    with Image.open(p) as f:
        assert f.mode == "I;16"
        want_rgb, want_l = np.asarray(f.convert("RGB")), np.asarray(f.convert("L"))
    np.testing.assert_array_equal(I.open_rgb(p), want_rgb)
    np.testing.assert_array_equal(I.to_gray_pil(I.open_rgb(p)), want_l)
    assert not np.array_equal(I.imread(p), want_rgb)


def test_open_rgb_applies_no_exif_orientation(tmp_path):
    img = _photo(64, 96, seed=3)
    exif = Image.Exif()
    exif[0x0112] = 6  # rotate 90 degrees clockwise to display
    for sub in (0, 2):  # 4:4:4 and 4:2:0
        p = tmp_path / f"exif{sub}.jpg"
        Image.fromarray(img).save(p, exif=exif.tobytes(), quality=90, subsampling=sub)
        with Image.open(p) as f:
            want = np.asarray(f.convert("RGB"))
        got = I.open_rgb(p)
        assert got.shape == (64, 96, 3)
        np.testing.assert_array_equal(got, want)
        # the cv2 read applies the tag: the same pixels, rotated
        np.testing.assert_array_equal(I.imread(p), np.rot90(got, k=-1))


def test_resize_nearest_matches_cv2():
    rng = np.random.default_rng(4)
    for (sh, sw), (dh, dw) in [((512, 512), (1024, 1024)), ((1024, 1024), (512, 512)),
                               ((7, 11), (5, 3)), ((7, 11), (22, 14)), ((37, 29), (101, 13))]:
        u8 = rng.integers(0, 256, (sh, sw), np.uint8)
        f32 = rng.random((sh, sw, 3)).astype(np.float32)
        for src in (u8, f32):
            want = cv2.resize(src, (dw, dh), interpolation=cv2.INTER_NEAREST)
            got = I.resize_nearest(src, dh, dw)
            assert got.dtype == src.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"{src.shape} -> {(dh, dw)}")


def test_resize_linear_exact_2x_shrink():
    """CelebA-HQ's 1024 px image and its float32 mask to 512."""
    u8 = _photo(1024, 1024, seed=5)
    want = cv2.resize(u8, (512, 512), interpolation=cv2.INTER_LINEAR)
    got = I.resize_linear(u8, 512, 512)
    np.testing.assert_array_equal(got, want)
    quad = [u8[i::2, j::2].astype(np.int32) for i in (0, 1) for j in (0, 1)]
    np.testing.assert_array_equal(got, (sum(quad) + 2) >> 2)

    f32 = np.random.default_rng(6).random((1024, 1024)).astype(np.float32)
    want = cv2.resize(f32, (512, 512), interpolation=cv2.INTER_LINEAR)
    got = I.resize_linear(f32, 512, 512)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    a, b, c, d = (f32[i::2, j::2] for i in (0, 1) for j in (0, 1))
    np.testing.assert_allclose(got, ((a + b) + (c + d)) * np.float32(0.25), atol=1e-6, rtol=0)
