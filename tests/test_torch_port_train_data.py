"""The port's training data (reface_tpu_torch/data: augment, celeba, ffhq,
synthetic, loader) against the JAX package's, on the CPU.

Every function draws from a np.random.Generator; the port must draw the same
numbers in the same order, so each comparison also holds the generators'
states equal afterwards. The JAX package runs cv2 (5.0 here); the port runs
numpy and its native library, with cv2's rules: exact bilinear remaps (cv2
5's float path), BORDER_CONSTANT zeros, BORDER_REFLECT / REFLECT_101,
getGaussianKernel's taps, cv2's box sums in float64.

Tolerances: a data tensor of an item may differ by at most one 8-bit level
of its [0, 1] data, LEVEL = 1/255, scaled by the tensor's own normalisation
(x 2 for [-1, 1] images, / CLIP's smallest std for the CLIP-normalised
reference); seen here: at most 0.01 level. The augmentation primitives on
random float inputs are held to AUG_TOL = 1e-4 (seen: 2.7e-5, the rotation's
coordinates computed in another order than cv2's).
"""

import numpy as np
import pytest

from test_torch_port_helpers import one_torch_thread

from reface_tpu.data import augment as JA
from reface_tpu.data import celeba as JC
from reface_tpu.data import ffhq as JF
from reface_tpu.data import loader as JLoader
from reface_tpu.data import synthetic as JS
from reface_tpu_torch.data import augment as PA
from reface_tpu_torch.data import celeba as PC
from reface_tpu_torch.data import ffhq as PF
from reface_tpu_torch.data import loader as PLoader
from reface_tpu_torch.data import synthetic as PS
from reface_tpu_torch.io.images import imread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

LEVEL = 1.0 / 255.0
AUG_TOL = 1e-4
ITEM_TOL = {"GT": 2 * LEVEL, "inpaint_image": 2 * LEVEL, "inpaint_mask": LEVEL,
            "ref_imgs": LEVEL / float(PA.CLIP_STD_NP.min()), "index": 0}


def _same_state(a: np.random.Generator, b: np.random.Generator) -> bool:
    return a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("scale,squeeze", [(None, True), (0.8, False)])
def test_tps_warp_mask_matches_jax(scale, squeeze):
    """The decow warp with its scale drawn (None) or given, on an (H, W) and
    an (H, W, 1) mask; the same draws in the same order."""
    rng = np.random.default_rng(1)
    mask = (rng.random((72, 60)) > 0.5).astype(np.float32)
    mask = mask if squeeze else mask[..., None]
    for seed in range(4):
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        ref = JA.tps_warp_mask_np(mask, rj, scale=scale)
        got = PA.tps_warp_mask_np(mask, rp, scale=scale)
        assert got.shape == ref.shape == mask.shape and got.dtype == np.float32
        assert np.abs(got - ref).max() <= AUG_TOL
        assert _same_state(rj, rp)


@pytest.mark.parametrize("flip_p,blur_p,elastic_p", [(0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                                     (1.0, 0.0, 1.0)])
def test_augment_reference_matches_jax(flip_p, blur_p, elastic_p):
    """resize to 224, flip, rotation, box blur (k 3, 5 or 7 as drawn) and the
    elastic remap, each forced on or off; several seeds each."""
    img = np.random.default_rng(2).random((300, 260, 3)).astype(np.float32)
    for seed in range(3):
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        kw = dict(flip_p=flip_p, blur_p=blur_p, elastic_p=elastic_p)
        ref = JA.augment_reference_np(img, rj, **kw)
        got = PA.augment_reference_np(img, rp, **kw)
        assert got.shape == ref.shape == (224, 224, 3)
        assert np.abs(got - ref).max() <= AUG_TOL
        assert _same_state(rj, rp)


def _check_items(jds, pds):
    assert len(jds) == len(pds)
    for i in range(len(jds)):
        ref, got = jds[i], pds[i]
        assert set(got) == set(ref)
        for k, tol in ITEM_TOL.items():
            assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
            err = float(np.abs(got[k].astype(np.float64) - ref[k]).max())
            assert err <= tol, (i, k, err * 255)


@pytest.fixture(scope="module")
def jax_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_trees")
    return (JS.make_synthetic_celeba(str(root / "celeba"), count=6, size=96, seed=3),
            JS.make_synthetic_ffhq(str(root / "ffhq"), count=3, size=64, seed=4))


@pytest.mark.parametrize("gray,state", [(True, "train"), (False, "train"),
                                        (True, "validation")])
def test_celeba_items_match_jax(jax_trees, gray, state):
    """Both item recipes (gray_outer_mask True: the decow-warped mask; False:
    the parsing classes' mask), train and validation, on the JAX package's
    synthetic tree, per-item SeedSequence([data_seed, index])."""
    kw = dict(dataset_dir=jax_trees[0], state=state, image_size=64, train_count=4,
              eval_count=2, gray_outer_mask=gray, data_seed=5)
    _check_items(JC.CelebAHQDataset(JC.CelebAHQConfig(**kw)),
                 PC.CelebAHQDataset(PC.CelebAHQConfig(**kw)))


def test_ffhq_items_match_jax(jax_trees):
    kw = dict(dataset_dir=jax_trees[1], state="train", image_size=48, train_count=3,
              data_seed=2)
    _check_items(JF.FFHQDataset(JF.FFHQConfig(**kw)), PF.FFHQDataset(PF.FFHQConfig(**kw)))


def test_port_synthetic_trees_read_by_both(tmp_path, jax_trees):
    """The port's trees (written through io/images.py) are read alike by both
    packages' datasets; their PNGs hold the JAX generator's pixels exactly
    (the JPEGs differ by encoder)."""
    celeba = PS.make_synthetic_celeba(str(tmp_path / "celeba"), count=6, size=96, seed=3)
    ffhq = PS.make_synthetic_ffhq(str(tmp_path / "ffhq"), count=3, size=64, seed=4)
    for sub in ("images512/00001.png", "BiSeNet_mask/00002.png"):
        gray = sub.startswith("BiSeNet")
        np.testing.assert_array_equal(imread(f"{ffhq}/{sub}", gray=gray),
                                      imread(f"{jax_trees[1]}/{sub}", gray=gray))
    np.testing.assert_array_equal(
        imread(f"{celeba}/CelebA-HQ-mask/Overall_mask/5.png", gray=True),
        imread(f"{jax_trees[0]}/CelebA-HQ-mask/Overall_mask/5.png", gray=True))
    kw = dict(dataset_dir=celeba, image_size=64, train_count=4, eval_count=2, data_seed=1)
    _check_items(JC.CelebAHQDataset(JC.CelebAHQConfig(**kw)),
                 PC.CelebAHQDataset(PC.CelebAHQConfig(**kw)))
    kw = dict(dataset_dir=ffhq, state="validation", image_size=64, train_count=1,
              eval_count=2)
    _check_items(JF.FFHQDataset(JF.FFHQConfig(**kw)), PF.FFHQDataset(PF.FFHQConfig(**kw)))


class _Indices:
    def __len__(self):
        return 23

    def __getitem__(self, i):
        return {"i": np.int64(i)}


def test_loader_order_matches_jax():
    """PrefetchLoader(shuffle=True, seed): the same batches in the same order
    as the JAX loader's, epoch after epoch (SeedSequence([seed, epoch]))."""
    ref = JLoader.PrefetchLoader(_Indices(), batch_size=4, shuffle=True, seed=7, num_workers=2)
    got = PLoader.PrefetchLoader(_Indices(), batch_size=4, shuffle=True, seed=7, num_workers=2)
    for _ in range(3):
        r = [b["i"].tolist() for b in ref]
        g = [b["i"].tolist() for b in got]
        assert g == r and len(g) == 5
