"""Progressive JPEG in the port's decoder (reface_tpu_torch/io/images.py,
native/image_codec.cpp) against cv2.imdecode (libjpeg-turbo), which the
JAX package's drivers read with, on the CPU.

Files written by cv2 (IMWRITE_JPEG_PROGRESSIVE: libjpeg's progression of
spectral selection and successive approximation, 4:2:0; with and without a
restart interval) and by PIL (progressive=True at each subsampling, and
gray), at sizes that are no multiple of the MCU, read as colour and as
gray: equal to cv2.imdecode pixel for pixel, the tolerance of the baseline
cases (tests/test_torch_port_images.py).
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from test_torch_port_helpers import one_torch_thread
from test_torch_port_images import _cv2, _smooth

from reface_tpu_torch.io import images as I

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _progressive(mode, img):
    if mode.startswith("cv2"):
        flags = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY,
                 95 if mode == "cv2_q95" else 75]
        if mode == "cv2_restart":
            flags += [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
        ok, enc = cv2.imencode(".jpg", img[..., ::-1], flags)
        return enc.tobytes()
    b = io.BytesIO()
    if mode == "pil_gray":
        Image.fromarray(img[..., 0]).save(b, "JPEG", quality=90, progressive=True)
    else:
        sub = {"pil_444": 0, "pil_422": 1, "pil_420": 2}[mode]
        Image.fromarray(img).save(b, "JPEG", quality=90, subsampling=sub, progressive=True)
    return b.getvalue()


@pytest.mark.parametrize("mode", ["cv2_q75", "cv2_q95", "cv2_restart", "pil_444", "pil_422",
                                  "pil_420", "pil_gray"])
def test_progressive_decode_matches_cv2(mode):
    img = _smooth(131, 197, seed=3)
    data = _progressive(mode, img)
    assert b"\xff\xc2" in data  # a progressive frame header
    if mode == "cv2_restart":
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    for gray in (False, True):
        want, got = _cv2(data, gray), I.imdecode(data, gray)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{mode} gray={gray}")


def test_progressive_scans_refine():
    """The later scans carry the high frequencies and the low bits: the
    file cut after its first scans decodes, its missing coefficients zero,
    further from the image than the whole file. (libjpeg smooths the blocks
    of such a file, whose coefficients are partly sent; the port does not,
    so only whole files are held to cv2's pixels.)"""
    img = _smooth(64, 80, seed=4)
    data = _progressive("cv2_q95", img)
    whole = I.imdecode(data)
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    assert len(sos) >= 6
    part = I.imdecode(data[:sos[3]] + b"\xff\xd9")
    assert part.shape == whole.shape
    assert np.abs(part.astype(int) - img).mean() > np.abs(whole.astype(int) - img).mean() + 1
