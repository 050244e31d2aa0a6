"""The test bench's data path (reface_tpu_torch/data, eval/protocol.py's
loaders) against the JAX package's (reface_tpu/data, reface_tpu/eval/
protocol.py, which read through cv2 and PIL) on the same files, written by
the port's encoders:

- TestBenchDataset items of a CelebA-style tree (JPEG images at twice the
  size, the exact 2x shrink; 19-class masks at half the image, brought up
  by INTER_NEAREST), an FFHQ-style tree (PNG, a 96 -> 64 shrink), an FF++
  tree with its pairs.txt, and a prior directory. The codecs are exact and
  INTER_NEAREST is; INTER_LINEAR is within one level on uint8 and 1e-5 on
  float32 (tests/test_torch_port_images.py), so the [-1, 1] images are
  held within one level (2/255), the masks within 1e-5 and the
  CLIP-normalized reference within 1e-5 / min(CLIP_STD).
- The protocol's loaders: clip_fid_load and expression_load bit for bit
  (PIL's bicubic), hopenet_load within 1e-6 (the bilinear resize without
  antialias, F.interpolate against the JAX gather-lerp),
  id_masked_112_load within one level of the INTER_LINEAR read over
  min(CLIP_STD), and parse_file_number.
- PrefetchLoader: the JAX loader's batches, order and ragged tail, in the
  thread and the (spawned) process worker modes.
"""

import os

import numpy as np
import pytest

from test_torch_port_helpers import one_torch_thread

from reface_tpu.data.loader import PrefetchLoader as JPrefetchLoader
from reface_tpu.data.test_bench import TestBenchConfig as JTestBenchConfig
from reface_tpu.data.test_bench import TestBenchDataset as JTestBenchDataset
from reface_tpu.eval import protocol as JP
from reface_tpu_torch.data import PrefetchLoader, TestBenchConfig, TestBenchDataset
from reface_tpu_torch.eval import protocol as PP
from reface_tpu_torch.io.images import imwrite
from reface_tpu_torch.nn.arcface import CLIP_STD

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

LEVEL = 2.0 / 255.0  # one uint8 level in [-1, 1]
F32 = 1e-5
PAIRS = 3


def _face(rng, size, msize):
    """A photo-like image and a 19-class mask with skin, eyes, mouth and hair."""
    coarse = rng.random((size // 16 + 2, size // 16 + 2, 3))
    idx = np.minimum((np.arange(size) * (coarse.shape[0] - 1)) // size, coarse.shape[0] - 1)
    img = coarse[idx][:, idx] * 200 + rng.normal(0, 20, (size, size, 3))
    mask = np.zeros((msize, msize), np.uint8)
    c, r = msize // 2, msize // 3
    ys, xs = np.ogrid[:msize, :msize]
    mask[(ys - c) ** 2 + (xs - c) ** 2 < r * r] = 1
    mask[c - r // 3:c - r // 6, c - r // 2:c - r // 4] = 4
    mask[c - r // 3:c - r // 6, c + r // 4:c + r // 2] = 5
    mask[c + r // 4:c + r // 2, c - r // 4:c + r // 4] = 10
    mask[:c - r] = 13
    return np.clip(img, 0, 255).astype(np.uint8), mask


def _write(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    imwrite(path, arr)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    rng = np.random.default_rng(0)
    out = {}
    celeba = TestBenchConfig(str(root / "celeba"), "celeba", image_size=64, num_pairs=PAIRS)
    ffhq = TestBenchConfig(str(root / "ffhq"), "ffhq", image_size=64, num_pairs=PAIRS)
    ff = TestBenchConfig(str(root / "ff"), "ff", image_size=64, num_pairs=PAIRS)
    for cfg, size, msize in ((celeba, 128, 64), (ffhq, 96, 96), (ff, 80, 80)):
        ids = [i for pair in cfg.pair_ids() for i in pair] if cfg.dataset != "ff" else range(6)
        if cfg.dataset == "ff":
            os.makedirs(cfg.dataset_dir, exist_ok=True)
            with open(os.path.join(cfg.dataset_dir, "pairs.txt"), "w") as f:
                f.write("0 3\n1 4\n\n2 5\n")
        for i in ids:
            img, mask = _face(rng, size, msize)
            _write(cfg.img_path(i), img)
            _write(cfg.mask_path(i), mask)
        out[cfg.dataset] = cfg
    prior = root / "priors"
    for k, (tid, _) in enumerate(celeba.pair_ids()):
        name = (f"{tid}.png", f"{tid}.jpg", f"{tid:05d}.png")[k]
        _write(str(prior / name), _face(rng, 96, 8)[0])
    out["prior"] = TestBenchConfig(celeba.dataset_dir, "celeba", image_size=64,
                                   num_pairs=PAIRS, prior_dir=str(prior))
    return out


def _jax_config(cfg):
    return JTestBenchConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@pytest.mark.parametrize("name", ["celeba", "ffhq", "ff", "prior"])
def test_test_bench_items_match_jax(trees, name):
    cfg = trees[name]
    got_ds, want_ds = TestBenchDataset(cfg), JTestBenchDataset(_jax_config(cfg))
    assert got_ds.pairs == want_ds.pairs and len(got_ds) == PAIRS
    tol = {"target_image": LEVEL, "inpaint_image": LEVEL, "prior_image": LEVEL,
           "inpaint_mask": F32, "ref_clip224": F32 / CLIP_STD.min()}
    for i in range(PAIRS):
        got, want = got_ds[i], want_ds[i]
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
            if k in tol:
                np.testing.assert_allclose(got[k], w, atol=tol[k], rtol=0, err_msg=k)
            else:
                assert got[k] == w, k
    if name == "celeba":  # the exact 2x shrink: bit for bit
        np.testing.assert_array_equal(got_ds[0]["target_image"], want_ds[0]["target_image"])


def test_protocol_loaders_match_jax(trees):
    cfg = trees["celeba"]
    imgs = [cfg.img_path(t) for t, _ in cfg.pair_ids()]
    masks = [cfg.mask_path(t) for t, _ in cfg.pair_ids()]
    np.testing.assert_array_equal(PP.clip_fid_load(imgs), JP.clip_fid_load(imgs))
    np.testing.assert_array_equal(PP.expression_load(imgs, size=48),
                                  JP.expression_load(imgs, size=48))
    np.testing.assert_allclose(PP.hopenet_load(imgs, size=40), JP.hopenet_load(imgs, size=40),
                               atol=1e-6, rtol=0)
    for key in ("celeba", "ffhq", "ff++"):
        got = PP.id_masked_112_load(imgs, masks, key)
        want = JP.id_masked_112_load(imgs, masks, key)
        np.testing.assert_allclose(got, want, atol=(1.0 / 255 + F32) / CLIP_STD.min(), rtol=0)
        assert ((got == 0) == (want == 0)).mean() > 0.99
    for name in ("29001_28001.png", "a/b-17.jpg", "x_y.png"):
        assert PP.parse_file_number(name) == JP.parse_file_number(name)


class _Items:
    """A picklable dataset of numbered items (spawned workers import it)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.int64(i), "x": np.full((2, 3), i, np.float32), "pid": np.int64(os.getpid())}


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_prefetch_loader_matches_jax(trees, mode):
    """The JAX loader's batches in its thread mode, by the port in both modes:
    the test bench in order with its ragged tail, and a seeded shuffle."""
    cfg = trees["celeba"]
    loader = PrefetchLoader(TestBenchDataset(cfg), batch_size=2, drop_last=False,
                            num_workers=2, worker_mode=mode)
    try:
        got = list(loader)
        want = list(JPrefetchLoader(JTestBenchDataset(_jax_config(cfg)), batch_size=2,
                                    drop_last=False, num_workers=2))
        assert len(loader) == 2 and [len(b["target_id"]) for b in got] == [2, 1]
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g["target_id"], w["target_id"])
            np.testing.assert_array_equal(g["source_id"], w["source_id"])
            np.testing.assert_allclose(g["target_image"], w["target_image"], atol=0, rtol=0)
    finally:
        loader.close()

    items = _Items(7)
    kw = dict(batch_size=3, shuffle=True, seed=5, drop_last=False, num_workers=2)
    loader, jax_loader = PrefetchLoader(items, worker_mode=mode, **kw), JPrefetchLoader(items, **kw)
    try:
        for _ in range(2):  # two epochs: a new order each, the pool kept
            got, want = list(loader), list(jax_loader)
            assert [len(b["idx"]) for b in got] == [3, 3, 1]
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(g["idx"], w["idx"])
                np.testing.assert_array_equal(g["x"][:, 0, 0], g["idx"])
        pids = np.concatenate([b["pid"] for b in got])
        assert (pids != os.getpid()).all() == (mode == "process")
    finally:
        loader.close()
