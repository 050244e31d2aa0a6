"""The port's swap driver (reface_tpu_torch/cli/swap.py) against the JAX
package's (reface_tpu/cli/swap.py), run as users run them, on the same tiny
checkpoint file and image files, on the CPU.

Both packages draw different random numbers, so the test patches each
package's FaceSwapper.swap at run time to start from the same initial
latent, and both run with sample_posterior=False (the encode's mode); both
read the same last.ckpt (tests/test_torch_port_ckpt.py's layout) at
--weights-dtype float32. The PNG files they write must agree within one
level of 255. The raw mode (detect, align, parse, swap, paste back) is held
to the port's own RawSwapPipeline.swap_images on the same inputs and
generator, which tests/test_torch_port_raw.py holds to the JAX package.
"""

import numpy as np
import pytest
import torch

from test_torch_port_ckpt import WIDE_ARCFACE, _lightning, _towers

from test_torch_port_helpers import one_torch_thread

from reface_tpu_torch.io.images import imread, imwrite

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

COMMON = ["--tiny", "--weights-dtype", "float32", "--seed", "3",
          "--overrides", "sample_posterior=False", WIDE_ARCFACE]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    torch.save(_lightning(_towers(seed=11)), d / "last.ckpt")
    rng = np.random.default_rng(0)
    (d / "src").mkdir()
    (d / "tgt").mkdir()
    imwrite(d / "src" / "a.png", rng.integers(0, 256, (72, 72, 3), dtype=np.uint8))
    imwrite(d / "tgt" / "b.png", rng.integers(0, 256, (80, 80, 3), dtype=np.uint8))
    imwrite(d / "tgt" / "c.jpg", rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    return d


def _fixed_latent(monkeypatch, cls, x_T):
    orig = cls.swap

    def swap(self, *args, **kw):
        kw["x_T"] = x_T
        return orig(self, *args, **kw)

    monkeypatch.setattr(cls, "swap", swap)


def test_precropped_matches_the_jax_driver(files, monkeypatch):
    """--precropped with the central-ellipse mask, a PNG and a JPEG target:
    the same output names (a .jpg target gives a .jpg), within one level."""
    from reface_tpu.cli import swap as jswap
    from reface_tpu.pipelines.swap import FaceSwapper as JSwapper
    from reface_tpu_torch.cli import swap as pswap
    from reface_tpu_torch.pipelines.swap import FaceSwapper as PSwapper

    x_T = np.random.default_rng(1).normal(size=(1, 8, 8, 4)).astype(np.float32)
    _fixed_latent(monkeypatch, JSwapper, x_T)
    _fixed_latent(monkeypatch, PSwapper, x_T)
    args = ["--precropped", "--ckpt", str(files / "last.ckpt"), "--source",
            str(files / "src"), "--target", str(files / "tgt"), *COMMON]
    jswap.main(["--backend", "cpu", "--outdir", str(files / "jax"), *args])
    done = pswap.main(["--device", "cpu", "--outdir", str(files / "port"), *args])
    assert [p.split("/")[-1] for p, _ in done] == ["a_b.png", "a_c.jpg"]
    for name in ("a_b.png", "a_c.jpg"):
        want = imread(files / "jax" / name).astype(int)
        got = imread(files / "port" / name).astype(int)
        assert got.shape == want.shape == (64, 64, 3)
        if name.endswith(".png"):
            assert np.abs(got - want).max() <= 1, name
        else:  # each file JPEG-coded by its own encoder: compare the levels
            assert np.abs(got - want).mean() < 2.0, name
    assert np.abs(imread(files / "port" / "a_b.png").astype(int) - 127).max() > 20


def test_raw_mode_writes_the_pipelines_output(files):
    """The raw mode without --precropped: the file equals
    RawSwapPipeline.swap_images on the same images, weights and seed, within
    one level; --guidance with --fused is refused, as by the JAX driver
    (tests/test_torch_port_cli_guided.py runs --guidance)."""
    import argparse

    from reface_tpu_torch.cli import swap as pswap
    from reface_tpu_torch.cli.common import add_model_args, build_raw_pipeline, build_swapper
    from reface_tpu_torch.pipelines.raw import tiny_raw_config

    argv = ["--device", "cpu", "--ckpt", str(files / "last.ckpt"), *COMMON]
    pswap.main(["--source", str(files / "src" / "a.png"), "--target",
                str(files / "tgt" / "b.png"), "--outdir", str(files / "raw"), *argv])
    got = imread(files / "raw" / "a_b.png").astype(int)
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--bisenet-ckpt", default=None)
    args = ap.parse_args(argv)
    pipe = build_raw_pipeline(args, build_swapper(args), tiny_raw_config())
    gen = torch.Generator().manual_seed(3)
    # the driver's own reader: the arrays, their strides included, are the
    # driver's (the random-weight LandmarkNet's points move with the layout
    # of the input at fp32 rounding, and the crop's homography magnifies it)
    want = pipe.swap_images(pswap._read01(files / "tgt" / "b.png")[None],
                            pswap._read01(files / "src" / "a.png")[None],
                            generator=gen)[0].numpy()
    assert got.shape == (80, 80, 3)
    assert np.abs(got - want * 255).max() <= 1.0
    with pytest.raises(SystemExit, match="--fused cannot be combined with --guidance"):
        pswap.main(["--source", "a", "--target", "b", "--outdir", "o", "--guidance", "id",
                    "--fused", *argv])
