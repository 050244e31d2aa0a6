"""The port's dataset preparation (reface_tpu_torch/cli/prepare_data.py)
against the JAX package's reface_tpu/cli/prepare_data.py, on the CPU.

- merge-celeba-masks: the merged 19-class masks bit-equal to the JAX ones
  (the same per-class PNGs read by both).
- expand-sd-checkpoint: every tensor of the written file equal to the JAX
  one's.
- estimate-ffhq-masks: one seeded BiSeNet file (face-parsing's layout) read
  by both, each running BiSeNetConfig()'s bf16; the masks equal except where
  BiSeNet's two best logits are tied to bf16 rounding, within TIE_ULPS bf16
  ulps of the best (the network's bf16 products leave a few ulps between the
  two packages' logits), where either class may win; MAX_DIFF bounds the
  count of such pixels.
- crop-and-mask: the crops and seg12 masks equal to the port's
  RawSwapPipeline called directly on the same seeded weights.
- make-priors: its flags parse, and directories without an image pair are
  refused as the JAX driver refuses them (tests/test_torch_port_cli_guided.py
  runs make-priors).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_port_helpers import one_torch_thread

from reface_tpu.cli import prepare_data as JP
from reface_tpu_torch.cli import prepare_data as PP
from reface_tpu_torch.data.synthetic import face_like, make_synthetic_celeba, write_celeba_class_masks
from reface_tpu_torch.io.images import imread, imwrite
from reface_tpu_torch.nn.bisenet import SEG_MEAN, SEG_STD, BiSeNet, BiSeNetConfig
from reface_tpu_torch.pipelines.raw import RawPipelineConfig, RawSwapPipeline
from reface_tpu_torch.pipelines.swap import FaceSwapper, init_params, tiny_swap_config

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TIE_ULPS = 6  # best - second best logit, in bf16 ulps of the best (seen <= 5.4)
MAX_DIFF = 128  # pixels that differ, all at ties: seen 91 of 3 x 64 x 64


def test_merge_celeba_masks_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for root in ("jax", "port"):
        for idx in (0, 1, 2001):  # two folders of the raw layout
            write_celeba_class_masks(str(tmp_path / root), idx, face_like(rng, 48)[1])
        rng = np.random.default_rng(0)
    JP.merge_celeba_masks(str(tmp_path / "jax"), count=2002)
    PP.main(["merge-celeba-masks", "--dataset-dir", str(tmp_path / "port"), "--count", "2002"])
    for idx in (0, 1, 2001):
        name = f"CelebA-HQ-mask/Overall_mask/{idx}.png"
        got = imread(tmp_path / "port" / name, gray=True)
        np.testing.assert_array_equal(got, imread(tmp_path / "jax" / name, gray=True))
        assert set(np.unique(got)) <= set(range(19)) and got.any()
    assert sorted(os.listdir(tmp_path / "port/CelebA-HQ-mask/Overall_mask")) == \
        ["0.png", "1.png", "2001.png"]


def test_expand_sd_checkpoint_matches_jax(tmp_path):
    g = torch.Generator().manual_seed(0)
    sd = {"model.diffusion_model.input_blocks.0.0.weight": torch.randn(8, 4, 3, 3, generator=g),
          "model.diffusion_model.input_blocks.0.0.bias": torch.randn(8, generator=g),
          "first_stage_model.decoder.conv_in.weight": torch.randn(4, 4, 3, 3, generator=g)}
    torch.save({"state_dict": sd, "global_step": 7}, tmp_path / "sd.ckpt")
    JP.expand_sd_checkpoint(str(tmp_path / "sd.ckpt"), str(tmp_path / "jax.ckpt"))
    PP.main(["expand-sd-checkpoint", "--src", str(tmp_path / "sd.ckpt"),
             "--dst", str(tmp_path / "port.ckpt")])
    load = lambda f: torch.load(tmp_path / f, weights_only=True)["state_dict"]
    ref, got = load("jax.ckpt"), load("port.ckpt")
    assert got.keys() == ref.keys() == sd.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    w = got["model.diffusion_model.input_blocks.0.0.weight"]
    assert w.shape == (8, 9, 3, 3) and not w[:, 4:].any()


def test_estimate_ffhq_masks_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for i in range(3):
        os.makedirs(tmp_path / "images512", exist_ok=True)
        imwrite(tmp_path / "images512" / f"{i:05d}.png", face_like(rng, 64)[0])
    net = init_params(BiSeNet(BiSeNetConfig()), seed=2)
    torch.save({k: v.float() for k, v in net.state_dict().items()}, tmp_path / "bisenet.pth")
    JP.estimate_ffhq_masks(str(tmp_path), str(tmp_path / "bisenet.pth"), batch=2)
    ref = {f: imread(tmp_path / "BiSeNet_mask" / f, gray=True)
           for f in sorted(os.listdir(tmp_path / "BiSeNet_mask"))}
    os.rename(tmp_path / "BiSeNet_mask", tmp_path / "jax_masks")
    PP.main(["estimate-ffhq-masks", "--dataset-dir", str(tmp_path), "--bisenet-ckpt",
             str(tmp_path / "bisenet.pth"), "--batch", "2", "--device", "cpu"])
    got = {f: imread(tmp_path / "BiSeNet_mask" / f, gray=True) for f in ref}
    assert list(ref) == ["00000.png", "00001.png", "00002.png"]
    diff = 0
    for f in ref:
        bad = got[f] != ref[f]
        if bad.any():
            x = torch.from_numpy(imread(tmp_path / "images512" / f)).float() / 255
            x = ((x - torch.from_numpy(SEG_MEAN)) / torch.from_numpy(SEG_STD)).permute(2, 0, 1)
            with torch.no_grad():
                logits = net(x[None])[0].float().permute(1, 2, 0).numpy()[bad]
            top2 = np.sort(logits.astype(np.float32), axis=-1)[:, -2:]
            ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[:, 1]))) - 7)
            assert np.all(top2[:, 1] - top2[:, 0] <= TIE_ULPS * ulp)
        diff += int(bad.sum())
    assert diff <= MAX_DIFF


def test_crop_and_mask_matches_raw_pipeline(tmp_path):
    """--allow-random: the seeded LandmarkNet and BiSeNet (init_params seed
    0), the tiny swapper the JAX driver also builds; the port's pipeline
    called directly on the same images gives the same crops and masks."""
    make_synthetic_celeba(str(tmp_path / "tree"), start=5, count=2, size=96, seed=3)
    PP.main(["crop-and-mask", "--dataset-dir", str(tmp_path / "tree"), "--out-dir",
             str(tmp_path / "out"), "--start", "5", "--count", "2", "--allow-random",
             "--device", "cpu"])
    pipe = RawSwapPipeline(FaceSwapper(tiny_swap_config(), device="cpu"), RawPipelineConfig(),
                           device="cpu")
    imgs = np.stack([imread(tmp_path / "tree" / "CelebA-HQ-img" / f"{i}.jpg")
                     for i in (5, 6)]).astype(np.float32) / 255
    crops, _ = pipe.align(imgs, pipe.detect_landmarks(imgs))
    seg = pipe.parse(crops).numpy()
    crops = np.clip(crops.numpy() * 255, 0, 255).astype(np.uint8)
    for j, i in enumerate((5, 6)):
        np.testing.assert_array_equal(imread(tmp_path / "out" / "crops" / f"{i}.png"), crops[j])
        np.testing.assert_array_equal(imread(tmp_path / "out" / "masks" / f"{i}.png", gray=True),
                                      seg[j])
    assert crops.shape[1:] == (1024, 1024, 3)


def test_make_priors_waits_for_a13(tmp_path):
    """make-priors ran no prior before the priors were ported (ROADMAP A13);
    now, as in the JAX driver, only directories without a pair exit."""
    argv = ["make-priors", "--target-dir", str(tmp_path), "--source-dir", str(tmp_path),
            "--mask-dir", str(tmp_path), "--out-dir", str(tmp_path), "--method", "dift"]
    for main in (JP.main, PP.main):
        with pytest.raises(SystemExit, match="no image pairs found"):
            main(argv)
