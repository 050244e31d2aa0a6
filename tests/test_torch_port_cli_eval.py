"""The slice as a whole: the port's two test-bench drivers on the CPU.

- cli.evaluate: the port's (`--device cpu`) and the JAX package's
  (`--backend cpu`) read the same torch files in the reference's layouts
  (an HF CLIP ViT-B/32 file, Hopenet with fc_finetune, a flat D3DFR file,
  ArcFace), written from JAX-initialised params through ckpt/from_jax.py,
  and score the same results directory of 4 swaps against a CelebA-style
  tree, each swap a noisy copy of a source (one of the wrong one). Both
  run CLIP and IR-SE-50 in bf16 (their defaults) and the ResNet-50s in
  fp32. The metrics agree: pose within 1e-3 degrees and
  expression within 1e-4 (fp32 towers); the mean ID cosine within 2e-2
  (bf16's distance for IR-SE-50), Top-1 and Top-5 exactly, the data
  chosen so that no swap's two best cosines lie within twice that distance
  (asserted); CLIP-FID within 20 times the
  JAX FID's own spread under 1e-6 relative perturbations of its features
  (with 4 swaps the 512 x 512 covariances are singular and sqrtm is
  ill-conditioned; the spread read ~1e-5 on FID ~66) plus 10 times its
  spread under bf16-sized (2^-8) ones (~0.06): the two bf16 CLIP towers
  differ by a rounding error correlated through 12 layers, up to a few
  times that of independent noise (0.05 seen on this data, 0.12 on
  unrelated random swaps).
- cli.inference_test_bench --tiny --device cpu on 3 pairs at --n-samples
  2: the results named {source}_{target}.png, the ragged tail padded to the
  batch and not written, the --save-aux dumps, and the first batch bit-equal
  (as written) to FaceSwapper.swap called directly with the same seed.
- The test bench's options reach FaceSwapper.swap as the JAX driver
  passes them: --start-from-target (the prior is the target, no
  landmarks); --prior-dir (the dataset's prior images) with --head-swap
  (the head-swap masks) and --landmark-ckpt (LandmarkNet's coordinates of
  the target).
- Both drivers default to --device cuda and raise without a card.
"""

import argparse
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reface_tpu.cli import evaluate as jax_evaluate
from reface_tpu.eval import backbones as JB
from reface_tpu.eval import fid as JF
from reface_tpu.eval import protocol as JPR
from reface_tpu.nn.arcface import ArcFaceConfig as JArcFaceConfig
from reface_tpu.nn.arcface import IRSE50 as JIRSE50
from reface_tpu.nn.clip import CLIPVisionTower as JCLIPVisionTower
from reface_tpu_torch.cli import evaluate, inference_test_bench
from reface_tpu_torch.cli.common import add_model_args, build_swapper, save_image_pm1
from reface_tpu_torch.ckpt import from_jax as FJ
from reface_tpu_torch.data import TestBenchConfig, TestBenchDataset, collate
from reface_tpu_torch.eval import protocol as PPR
from reface_tpu_torch.io.images import imread, imwrite, resize_linear
from reface_tpu_torch.pipelines.swap import FaceSwapper
from test_torch_port_helpers import init_jax
from test_torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

SWAPS = 4
BF16 = 2e-2


def _photo(rng, size):
    coarse = rng.random((size // 16 + 2, size // 16 + 2, 3))
    idx = np.minimum(np.arange(size) * (coarse.shape[0] - 1) // size, coarse.shape[0] - 1)
    return np.clip(coarse[idx][:, idx] * 220 + rng.normal(0, 15, (size, size, 3)), 0,
                   255).astype(np.uint8)


def _mask(size):
    m = np.zeros((size, size), np.uint8)
    c, r = size // 2, size // 3
    ys, xs = np.ogrid[:size, :size]
    m[(ys - c) ** 2 + (xs - c) ** 2 < r * r] = 1
    m[c + r // 4:c + r // 2, c - r // 4:c + r // 4] = 10
    m[:c - r] = 13
    return m


def _celeba_tree(root, pairs, size=128, msize=64, seed=0):
    rng = np.random.default_rng(seed)
    cfg = TestBenchConfig(str(root), "celeba", num_pairs=pairs)
    for pair in cfg.pair_ids():
        for i in pair:
            for path, arr in ((cfg.img_path(i), _photo(rng, size)),
                              (cfg.mask_path(i), _mask(msize))):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                imwrite(path, arr)
    return cfg


@pytest.fixture(scope="module")
def eval_files(tmp_path_factory):
    """A CelebA-style tree, 4 swaps, and the four tower files."""
    root = tmp_path_factory.mktemp("eval")
    cfg = _celeba_tree(root / "data", SWAPS)
    rng = np.random.default_rng(1)
    os.makedirs(root / "results")
    # each swap a noisy 64 px copy of a source, the last one of the first
    # pair's source: Top-1 0.75, and the seeded IR-SE-50's cosines rank
    # the copied source first by far more than bf16's distance
    pair_ids = cfg.pair_ids()
    for (t, s), (_, like) in zip(pair_ids, pair_ids[:-1] + pair_ids[:1]):
        img = resize_linear(imread(cfg.img_path(like)), 64, 64).astype(np.float32)
        imwrite(str(root / "results" / f"{s}_{t}.png"),
                np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8))
    z224, z112 = jnp.zeros((1, 224, 224, 3)), jnp.zeros((1, 112, 112, 3))
    params = {"clip": init_jax(JCLIPVisionTower(JF.CLIP_B32), z224, seed=2),
              "arcface": init_jax(JIRSE50(JArcFaceConfig()), z112, seed=3),
              "hopenet": init_jax(JB.Hopenet(), z224, seed=4),
              "facerecon": init_jax(JB.FaceReconCoeffNet(), z224, seed=5)}
    hopenet = FJ.hopenet_from_jax(params["hopenet"])
    hopenet.update({"fc_finetune.weight": torch.zeros(66, 2048),
                    "fc_finetune.bias": torch.zeros(66)})
    files = {"clip": FJ.clip_vision_from_jax(params["clip"]),  # HF CLIPModel names
             "arcface": FJ.arcface_from_jax(params["arcface"]),
             "hopenet": hopenet,
             # the flat layout both drivers read: conv1.* and final_layers.*
             "facerecon": FJ.facerecon_from_jax(params["facerecon"])}
    flags = []
    for name, sd in files.items():
        path = root / f"{name}.pth"
        torch.save(sd, path)
        flags += [f"--{name}-ckpt", str(path)]
    return root, cfg, params, flags


def test_evaluate_matches_jax(eval_files):
    root, cfg, params, flags = eval_files
    common = ["--results-dir", str(root / "results"), "--dataset-dir", cfg.dataset_dir,
              "--dataset", "celeba", *flags]
    got = evaluate.main([*common, "--device", "cpu", "--out", str(root / "port.json")])
    jax_evaluate.main([*common, "--backend", "cpu", "--out", str(root / "jax.json")])
    with open(root / "jax.json") as f:
        want = json.load(f)
    with open(root / "port.json") as f:
        assert json.load(f) == got
    assert set(got) == set(want) == {"clip_fid", "top1", "top5", "mean_id_cosine",
                                     "pose_l2_deg", "expression_l2"}
    assert all(np.isfinite(v) for v in got.values())
    np.testing.assert_allclose(got["pose_l2_deg"], want["pose_l2_deg"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["expression_l2"], want["expression_l2"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["mean_id_cosine"], want["mean_id_cosine"], atol=BF16, rtol=0)

    # Top-1/Top-5 are held exactly: on this data no swap's two best cosines
    # (the port's IR-SE-50, read from the same file) lie within twice
    # bf16's distance, so the ranking is not a rounding's choice
    pairs = sorted((s, t) for t, s in cfg.pair_ids())
    src = PPR.id_masked_112_load([cfg.img_path(s) for s, _ in pairs],
                                 [cfg.mask_path(s) for s, _ in pairs], "celeba")
    swp = PPR.id_masked_112_load([str(root / "results" / f"{s}_{t}.png") for s, t in pairs],
                                 [cfg.mask_path(t) for _, t in pairs], "celeba")
    arcface = evaluate.build_tower("id", flags[flags.index("--arcface-ckpt") + 1], "cpu")
    sim = PPR.id_embed_protocol(arcface, swp) @ PPR.id_embed_protocol(arcface, src).T
    top2 = np.sort(sim, axis=1)[:, -2:]
    gap = (top2[:, 1] - top2[:, 0]).min()
    assert gap > 2 * BF16, f"two best cosines {gap} apart: the ranking is bf16's choice"
    assert got["top1"] == want["top1"] == 0.75 and got["top5"] == want["top5"] == 1.0

    # FID: the JAX FID's spread under 1e-6 perturbations of its features
    swaps = sorted(str(p) for p in (root / "results").iterdir())
    data = sorted(str(p) for p in (root / "data" / "CelebA-HQ-img").iterdir())
    feats = JF.clip_features(params["clip"], jnp.asarray(JPR.clip_fid_load(swaps + data)))
    fs, fd = feats[:len(swaps)], feats[len(swaps):]
    fid0 = JF.clip_fid(fs, fd)
    np.testing.assert_allclose(fid0, want["clip_fid"], rtol=1e-6)
    rng = np.random.default_rng(7)
    spread = {scale: max(abs(JF.clip_fid(fs * (1 + rng.normal(0, scale, fs.shape)),
                                         fd * (1 + rng.normal(0, scale, fd.shape))) - fid0)
                         for _ in range(3)) for scale in (1e-6, 2.0**-8)}
    np.testing.assert_allclose(got["clip_fid"], want["clip_fid"],
                               atol=20 * spread[1e-6] + 10 * spread[2.0**-8], rtol=0)


def test_inference_test_bench_tiny(tmp_path, monkeypatch):
    cfg = _celeba_tree(tmp_path / "data", 3, size=128, msize=64)
    batches = []
    swap = FaceSwapper.swap

    def recording_swap(self, **kw):
        batches.append(kw["target_image"].shape[0])
        return swap(self, **kw)

    monkeypatch.setattr(FaceSwapper, "swap", recording_swap)
    out = tmp_path / "out"
    times, seconds = inference_test_bench.main(
        ["--tiny", "--device", "cpu", "--dataset-dir", cfg.dataset_dir, "--outdir", str(out),
         "--n-samples", "2", "--num-pairs", "3", "--save-aux", "--seed", "7"])
    assert batches == [2, 2] and len(times) == 2  # the tail of 1 padded to 2
    assert seconds >= sum(times)
    names = [f"{s}_{t}.png" for t, s in cfg.pair_ids()]
    assert sorted(os.listdir(out / "results")) == names
    for sub, name in (("GT", "{t}.png"), ("inpaint", "{t}.png"), ("mask", "{t}.png"),
                      ("grid", "{s}_{t}.png")):
        assert sorted(os.listdir(out / sub)) == sorted(name.format(s=s, t=t)
                                                       for t, s in cfg.pair_ids())
    assert imread(out / "grid" / names[0]).shape == (64, 192, 3)

    # the first batch, FaceSwapper.swap called directly with the same seed,
    # on the swapper the driver builds (weights rounded through bf16)
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    swapper = build_swapper(ap.parse_args(["--tiny", "--device", "cpu", "--seed", "7"]))
    ds = TestBenchDataset(dataclasses.replace(cfg, image_size=64))
    batch = collate([ds[0], ds[1]])
    direct = swap(swapper, target_image=batch["target_image"],
                  inpaint_image=batch["inpaint_image"], inpaint_mask=batch["inpaint_mask"],
                  ref_clip224=batch["ref_clip224"],
                  generator=torch.Generator().manual_seed(7)).numpy()
    for i in range(2):
        save_image_pm1(str(tmp_path / "direct.png"), direct[i])
        np.testing.assert_array_equal(imread(out / "results" / names[i]),
                                      imread(tmp_path / "direct.png"))


@pytest.mark.parametrize("option", ["start-from-target", "prior-dir head-swap landmarks"])
def test_inference_test_bench_options(tmp_path, monkeypatch, option):
    from reface_tpu_torch.nn.landmarks import LandmarkNet, LandmarkNetConfig, landmark_fn_from_net
    from reface_tpu_torch.pipelines.swap import init_params
    from reface_tpu_torch.preprocess.masks import HEAD_SWAP_CELEBA

    cfg = dataclasses.replace(_celeba_tree(tmp_path / "data", 2, size=96, msize=48),
                              image_size=64)
    calls = []
    swap = FaceSwapper.swap

    def recording_swap(self, **kw):
        calls.append(kw)
        return swap(self, **kw)

    monkeypatch.setattr(FaceSwapper, "swap", recording_swap)
    if option == "start-from-target":
        flags = ["--start-from-target"]
    else:
        rng = np.random.default_rng(3)
        os.makedirs(tmp_path / "priors")
        for t, _ in cfg.pair_ids():
            imwrite(str(tmp_path / "priors" / f"{t}.png"), _photo(rng, 80))
        net = LandmarkNet(LandmarkNetConfig())
        init_params(net, seed=4)
        torch.save(net.state_dict(), tmp_path / "lm.pth")
        flags = ["--prior-dir", str(tmp_path / "priors"), "--head-swap",
                 "--landmark-ckpt", str(tmp_path / "lm.pth")]
        cfg = dataclasses.replace(cfg, prior_dir=str(tmp_path / "priors"),
                                  remove_tar=HEAD_SWAP_CELEBA, preserve_src=HEAD_SWAP_CELEBA)
    inference_test_bench.main(["--tiny", "--device", "cpu", "--dataset-dir", cfg.dataset_dir,
                               "--outdir", str(tmp_path / "out"), "--n-samples", "2",
                               "--num-pairs", "2", *flags])
    assert len(calls) == 1
    batch, kw = collate([TestBenchDataset(cfg)[i] for i in range(2)]), calls[0]
    for k in ("target_image", "inpaint_image", "inpaint_mask", "ref_clip224"):
        np.testing.assert_array_equal(kw[k], batch[k], err_msg=k)
    if option == "start-from-target":
        np.testing.assert_array_equal(kw["prior_image"], batch["target_image"])
        assert kw["landmarks"] is None
    else:
        np.testing.assert_array_equal(kw["prior_image"], batch["prior_image"])
        assert kw["landmarks"].shape == (2, 136)
        torch.testing.assert_close(kw["landmarks"],
                                   landmark_fn_from_net(net.eval(), 64)(batch["target_image"]),
                                   rtol=0, atol=0)


def test_drivers_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = _celeba_tree(tmp_path / "data", 1, size=32, msize=32)
    os.makedirs(tmp_path / "results")
    imwrite(str(tmp_path / "results" / "29000_28000.png"), np.zeros((32, 32, 3), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--results-dir", str(tmp_path / "results"),
                       "--dataset-dir", cfg.dataset_dir, "--allow-random"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference_test_bench.main(["--tiny", "--dataset-dir", cfg.dataset_dir,
                                   "--outdir", str(tmp_path / "out"), "--num-pairs", "1"])
