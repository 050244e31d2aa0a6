"""The raw path's preprocessing in reface_tpu_torch against the JAX package,
fp32, CPU: the segmentation tables and LUT takes (preprocess/masks.py), the
alignment and paste-back warps (preprocess/align.py; batched in the port,
vmapped on the JAX side), the face boxes (preprocess/detect.py) and the
nearest resize (ops/resize.py).

The warps are held to ATOL (2e-4) on [0,1] images: fp32 on both sides, the
same expressions in the same order; the homography is an fp32 normal-
equations LU solve on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import ATOL, nchw, nhwc
from test_torch_port_helpers import one_torch_thread

from reface_tpu.data.synthetic import LANDMARK68_TEMPLATE
from reface_tpu.preprocess import align as JA
from reface_tpu.preprocess import detect as JD
from reface_tpu.preprocess import masks as JM
from reface_tpu_torch.ops.resize import resize_nearest
from reface_tpu_torch.preprocess import align as PA
from reface_tpu_torch.preprocess import detect as PD
from reface_tpu_torch.preprocess import masks as PM

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def faces(b, h, w, seed=0):
    """(b, 68, 2) landmarks of faces in an (h, w) frame: the iBUG-68
    template under a random similarity transform."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        ang = rng.uniform(-0.3, 0.3)
        rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        scale = rng.uniform(0.4, 0.7) * min(h, w)
        centre = np.array([w, h]) * rng.uniform(0.4, 0.6, 2)
        pts = (LANDMARK68_TEMPLATE - 0.5) @ rot.T * scale + centre
        out.append(pts + rng.normal(0, 0.5, pts.shape))
    return np.asarray(out, np.float32)


def test_masks_match_jax():
    """The label tables and LUTs are the JAX package's; remap,
    preserve_mask and inpaint_mask_from_classes agree on numpy masks and,
    as torch tensors, with the JAX functions on jnp masks."""
    for name in ("CELEBAHQ_LABELS", "FACE_PARSING_LABELS", "SEG9_LABELS", "SEG12_LABELS",
                 "DEFAULT_PRESERVE_CELEBA", "DEFAULT_PRESERVE_CELEBA_SRC_TEST",
                 "DEFAULT_PRESERVE_FFHQ_SEG12", "HEAD_SWAP_CELEBA", "HEAD_SWAP_SEG12"):
        assert getattr(PM, name) == getattr(JM, name), name
    for name in ("CELEBAHQ_TO_SEG12", "CELEBAHQ_TO_SEG9", "FACE_PARSING_TO_SEG12"):
        np.testing.assert_array_equal(getattr(PM, name), getattr(JM, name))
    mask = np.random.default_rng(1).integers(0, 19, (2, 16, 16)).astype(np.int32)
    classes = JM.DEFAULT_PRESERVE_FFHQ_SEG12
    seg12 = JM.remap(mask, JM.FACE_PARSING_TO_SEG12)
    np.testing.assert_array_equal(PM.remap(mask, PM.FACE_PARSING_TO_SEG12), seg12)
    np.testing.assert_array_equal(PM.remap(torch.from_numpy(mask), PM.FACE_PARSING_TO_SEG12),
                                  np.asarray(JM.remap(jnp.asarray(mask), JM.FACE_PARSING_TO_SEG12)))
    for fn in ("preserve_mask", "inpaint_mask_from_classes"):
        np.testing.assert_array_equal(getattr(PM, fn)(seg12, classes),
                                      getattr(JM, fn)(seg12, classes))
        np.testing.assert_array_equal(getattr(PM, fn)(torch.from_numpy(seg12), classes).numpy(),
                                      np.asarray(getattr(JM, fn)(jnp.asarray(seg12), classes)))


def test_align_quad_and_crop_match_jax():
    """compute_align_quad and quad_crop, batched, against the JAX functions
    vmapped, on faces that reach past the frame's edge (the clamped
    neighbours); bilinear_sample also at coordinates outside the image."""
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(3, 72, 90, 3)).astype(np.float32)
    lm = faces(3, 72, 90, seed=3)
    lm[2] += np.float32(40.0)  # pushes the third quad past the bottom-right edge
    jq = jax.vmap(JA.compute_align_quad)(jnp.asarray(lm))
    pq = PA.compute_align_quad(torch.from_numpy(lm))
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), atol=1e-4, rtol=0)
    crop = lambda im, q: JA.quad_crop(im, q, 48)
    ref = jax.vmap(crop)(jnp.asarray(img), jq)
    got = PA.quad_crop(nchw(img), torch.from_numpy(np.array(jq)), 48)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=ATOL, rtol=0)
    xs = rng.uniform(-5, 95, (3, 20, 30)).astype(np.float32)
    ys = rng.uniform(-5, 77, (3, 20, 30)).astype(np.float32)
    ref = jax.vmap(JA.bilinear_sample)(*map(jnp.asarray, (img, xs, ys)))
    got = PA.bilinear_sample(nchw(img), torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("with_mask", [False, True])
def test_paste_back_matches_jax(with_mask):
    """calc_perspective_coeffs, perspective_warp and paste_back, batched,
    with and without a crop-space mask, on quads from faces in a 96 x 120
    frame (one reaching past the edge)."""
    rng = np.random.default_rng(4)
    b, s = 3, 64
    frame = rng.uniform(size=(b, 96, 120, 3)).astype(np.float32)
    crop = rng.uniform(size=(b, s, s, 3)).astype(np.float32)
    cmask = rng.uniform(size=(b, s, s, 1)).astype(np.float32) if with_mask else None
    lm = faces(b, 96, 120, seed=5)
    lm[1] -= np.float32(30.0)
    quads = np.array(jax.vmap(JA.compute_align_quad)(jnp.asarray(lm)))
    corners = np.array([[-0.5, -0.5], [-0.5, s - 0.5], [s - 0.5, s - 0.5], [s - 0.5, -0.5]],
                       np.float32)
    jc = jax.vmap(lambda q: JA.calc_perspective_coeffs(q, corners))(jnp.asarray(quads))
    pc = PA.calc_perspective_coeffs(torch.from_numpy(quads), torch.from_numpy(corners))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-6)
    ref = jax.vmap(lambda im, c: JA.perspective_warp(im, c, 96, 120))(jnp.asarray(crop), jc)
    got = PA.perspective_warp(nchw(crop), torch.from_numpy(np.array(jc)), 96, 120)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=ATOL, rtol=0)
    if with_mask:
        ref = jax.vmap(JA.paste_back)(*map(jnp.asarray, (frame, crop, quads, cmask)))
    else:
        ref = jax.vmap(lambda o, c, q: JA.paste_back(o, c, q))(
            *map(jnp.asarray, (frame, crop, quads)))
    got = PA.paste_back(nchw(frame), nchw(crop), torch.from_numpy(quads),
                        None if cmask is None else nchw(cmask))
    assert 0.05 < float((np.asarray(ref) != frame).mean()) < 0.95  # a real blend
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=ATOL, rtol=0)


def test_face_bbox_matches_jax():
    """Boxes and validity of seg12 maps with a face, with too few face
    pixels, and with none."""
    rng = np.random.default_rng(6)
    seg = rng.integers(0, 12, (3, 40, 50)).astype(np.int32)
    seg[0] = np.where(seg[0] == 6, 0, seg[0])
    seg[1] = 0
    seg[1, 10:12, 20:25] = 6  # 10 face pixels: below min_pixels
    seg[2] = 0
    seg[2, 5:30, 7:41] = np.where(rng.uniform(size=(25, 34)) > 0.5, 5, 8)
    jb, jv = JD.face_bbox_from_mask(jnp.asarray(seg))
    pb, pv = PD.face_bbox_from_mask(torch.from_numpy(seg))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert pv.tolist() == [True, False, True]
    assert PD.FACE_CLASSES_SEG12 == JD.FACE_CLASSES_SEG12


@pytest.mark.parametrize("pairs", [((64, 100), (100, 64)), ((40, 98), (512, 1080)),
                                   ((512, 1024), (96, 37))])
def test_resize_nearest_matches_jax(pairs):
    """The same source pixels as jax.image.resize(..., "nearest") at
    integer and non-integer ratios, up and down; 40 -> 98 has a
    (i + 0.5) * in / out that is an integer (i = 73), where torch's
    "nearest-exact" picks another pixel."""
    (h0, h1), (w0, w1) = pairs
    x = np.random.default_rng(7).integers(0, 19, (2, h0, w0, 1)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, h1, w1, 1), "nearest")
    got = resize_nearest(nchw(x), h1, w1)
    np.testing.assert_array_equal(nhwc(got), np.asarray(ref))
    seg = torch.from_numpy(x[..., 0].astype(np.int32))[:, None]
    assert resize_nearest(seg, h1, w1).dtype == torch.int32
