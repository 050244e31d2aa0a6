"""The port's host runtime library (reface_tpu_torch/native_ops.py, built
by g++ from reface_tpu_torch/native/reface_native.cpp) against the JAX
package's binding of the same C++ (reface_tpu/native_ops.py), every entry
point on the same inputs, and the ERT landmark functions of both packages
on a synthetic model written by tools.convert_dlib_sp.write_model. Both
libraries are the same source compiled with the same flags: the outputs
agree to float rounding (1e-6; -march=native may contract differently on
the machine that built the JAX package's library). A failed build raises
with g++'s output.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from reface_tpu import native_ops as jn
from reface_tpu.nn import landmarks as JL
from reface_tpu_torch import native_ops as pn
from reface_tpu_torch.nn import landmarks as PL
from tools.convert_dlib_sp import write_model

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-6, rtol=1e-6)


def test_build_from_the_ports_copy():
    """The port builds its own copy of the C++ source (the JAX package's,
    byte for byte) into build/torch_native/, named by the source's hash."""
    src = ROOT / "reface_tpu_torch" / "native" / "reface_native.cpp"
    assert src.read_bytes() == (ROOT / "native" / "src" / "reface_native.cpp").read_bytes()
    path = pn.build()
    assert path == pn.library_path() and path.exists()
    assert path.parent == ROOT / "build" / "torch_native"


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises RuntimeError with the compiler's output;
    nothing falls back."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int rn_broken( { return 0; }\n")
    monkeypatch.setattr(pn, "_SRC", bad)
    monkeypatch.setattr(pn, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pn, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)native library build failed.*error:"):
        pn.u8_to_pm1(np.zeros(4, np.uint8))
    assert not list((tmp_path / "build").glob("*.so"))


def test_warps_match():
    """resize_bilinear (up and down) and remap_bilinear (coordinates past
    the edges), and the TPS grid."""
    rng = np.random.default_rng(0)
    src = rng.random((37, 53, 3), np.float32)
    for dh, dw in ((64, 48), (20, 90)):
        np.testing.assert_allclose(pn.resize_bilinear(src, dh, dw),
                                   jn.resize_bilinear(src, dh, dw), **TOL)
    map_x = rng.uniform(-2, 55, (16, 24)).astype(np.float32)
    map_y = rng.uniform(-2, 39, (16, 24)).astype(np.float32)
    np.testing.assert_allclose(pn.remap_bilinear(src, map_x, map_y),
                               jn.remap_bilinear(src, map_x, map_y), **TOL)
    lin = np.linspace(-1, 1, 3)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    ctrl = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    warped = ctrl + rng.normal(0, 0.1, ctrl.shape).astype(np.float32)
    np.testing.assert_allclose(pn.tps_grid(ctrl, warped, 20, 24),
                               jn.tps_grid(ctrl, warped, 20, 24), atol=1e-5, rtol=0)


def test_mask_and_normalize_match():
    """mask_remap, preserve_mask, u8_to_pm1 and u8_to_clip."""
    from reface_tpu_torch.preprocess.masks import CELEBAHQ_TO_SEG12

    rng = np.random.default_rng(3)
    mask = rng.integers(0, 19, (64, 64)).astype(np.int32)
    np.testing.assert_array_equal(pn.mask_remap(mask, CELEBAHQ_TO_SEG12),
                                  jn.mask_remap(mask, CELEBAHQ_TO_SEG12))
    np.testing.assert_array_equal(pn.preserve_mask(mask, (1, 2, 13)),
                                  jn.preserve_mask(mask, (1, 2, 13)))
    img = rng.integers(0, 256, (16, 16, 3), np.uint8)
    np.testing.assert_allclose(pn.u8_to_pm1(img), jn.u8_to_pm1(img), **TOL)
    np.testing.assert_allclose(pn.u8_to_clip(img), jn.u8_to_clip(img), **TOL)


def _ert_model(tmp_path, n_points=68, seed=0) -> str:
    """A synthetic two-cascade ERT with random splits and leaves, so that the
    prediction depends on the pixels under each feature."""
    rng = np.random.default_rng(seed)
    init = rng.uniform(0.2, 0.8, n_points * 2).astype(np.float32)
    depth, n_feats = 3, 16
    cascades = []
    for _ in range(2):
        trees = []
        for _ in range(4):
            splits = [(int(rng.integers(n_feats)), int(rng.integers(n_feats)),
                       float(rng.uniform(-40, 40))) for _ in range((1 << depth) - 1)]
            leaves = rng.normal(0, 0.02, (1 << depth, n_points * 2)).astype(np.float32)
            trees.append((splits, leaves))
        cascades.append(dict(anchors=rng.integers(0, n_points, n_feats).astype(np.int32),
                             deltas=rng.normal(0, 0.05, (n_feats, 2)).astype(np.float32),
                             trees=trees))
    path = str(tmp_path / "synthetic.rert")
    write_model(path, init, cascades)
    return path


def test_ert_matches(tmp_path):
    """ert_load, ert_predict and ert_predict_batch on a synthetic model; a
    file that is not a model is refused by both."""
    path = _ert_model(tmp_path, n_points=5)
    rng = np.random.default_rng(1)
    grays = rng.integers(0, 255, (3, 50, 60), np.uint8)
    boxes = np.array([[5, 5, 45, 45], [0, 0, 59, 49], [10, 2, 30, 40]], np.float32)
    pn.ert_load(path)
    jn.ert_load(path)
    batch = pn.ert_predict_batch(grays, boxes)
    assert batch.shape == (3, 5, 2)
    np.testing.assert_allclose(batch, jn.ert_predict_batch(grays, boxes), **TOL)
    for i in range(3):
        np.testing.assert_allclose(pn.ert_predict(grays[i], boxes[i]), batch[i], **TOL)
    bad = tmp_path / "bad.rert"
    bad.write_bytes(b"not a model")
    with pytest.raises(RuntimeError, match="ert model load failed"):
        pn.ert_load(str(bad))


def test_rert_landmark_fns_match(tmp_path):
    """landmark_fn_from_rert ([-1,1] images, (B, 136) at image_size) and
    landmark68_fn_from_rert ([0,1] images, numpy or tensors, (B, 68, 2) at
    the input scale) against the JAX package's."""
    path = _ert_model(tmp_path, seed=2)
    rng = np.random.default_rng(4)
    pm1 = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    got = PL.landmark_fn_from_rert(path, 512)(pm1)
    ref = JL.landmark_fn_from_rert(path, 512)(pm1)
    assert got.shape == (2, 136)
    np.testing.assert_allclose(got, ref, **TOL)
    img01 = rng.uniform(0, 1, (3, 48, 40, 3)).astype(np.float32)
    fn = PL.landmark68_fn_from_rert(path)
    ref = JL.landmark68_fn_from_rert(path)(img01)
    for x in (img01, torch.from_numpy(img01)):
        got = fn(x)
        assert got.shape == (3, 68, 2) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, **TOL)
    assert np.ptp(ref[..., 0]) > 1.0  # the landmarks spread over the image
