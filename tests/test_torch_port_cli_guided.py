"""The port's drivers on the paths of the guided swap and the priors, on the
CPU: cli.swap --guidance (reface_tpu_torch/cli/swap.py) and cli.prepare_data
make-priors, with the test bench reading the priors.

- The towers the guided driver builds for "seg" (fp32 BiSeNet at 256 px)
  and "exp" (fp32 D3DFR at 224 px, coefficients 80:144), read from the same
  reference-layout files by both packages' drivers (each package's
  swap_guided patched to record what it is handed), held to each other.
- --guidance id,seg,exp --precropped: the PNG within one level of
  FaceSwapper.swap_guided called directly with the driver's swapper,
  towers and generator (tests/test_torch_port_guidance.py holds swap_guided
  to the JAX package's); the raw mode, whose every swap runs inside
  RawSwapPipeline's inference mode, within one level of the pipeline called
  directly; --fused with --guidance and unknown terms refused.
- make-priors: its pairing, mask lookup, resizes and file names against the
  JAX driver's (both packages' prior functions patched to record their
  inputs); both methods on a tiny tree, a prior equal to its target outside
  the mask and the DIFT one to dift_prior called directly; then
  cli.inference_test_bench --prior-dir on the DIFT priors within one level
  of FaceSwapper.swap(prior_image=...).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_port_ckpt import WIDE_ARCFACE, _lightning, _towers

from test_torch_port_helpers import one_torch_thread

from reface_tpu_torch.cli import prepare_data as pprep
from reface_tpu_torch.cli import swap as pswap
from reface_tpu_torch.cli.common import build_raw_pipeline, build_swapper
from reface_tpu_torch.io.images import imread, imwrite, resize_linear
from reface_tpu_torch.pipelines.swap import FaceSwapper as PSwapper
from reface_tpu_torch.pipelines.swap import init_params

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

COMMON = ["--tiny", "--weights-dtype", "float32", "--seed", "3",
          "--overrides", "sample_posterior=False", WIDE_ARCFACE]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny last.ckpt, two images, and the BiSeNet and D3DFR towers as the
    reference's files (face-parsing's 79999_iter.pth keys; Deep3DFaceRecon's
    net_recon.backbone.* trunk and net_recon.final_layers.* heads), seeded."""
    from reface_tpu_torch.eval.backbones import FaceReconCoeffNet
    from reface_tpu_torch.nn.bisenet import BiSeNet, BiSeNetConfig

    d = tmp_path_factory.mktemp("guided")
    torch.save(_lightning(_towers(seed=11)), d / "last.ckpt")
    rng = np.random.default_rng(0)
    (d / "src").mkdir()
    (d / "tgt").mkdir()
    imwrite(d / "src" / "a.png", rng.integers(0, 256, (72, 72, 3), dtype=np.uint8))
    imwrite(d / "tgt" / "b.png", rng.integers(0, 256, (80, 80, 3), dtype=np.uint8))
    bise = init_params(BiSeNet(BiSeNetConfig(dtype=torch.float32), device="cpu"), seed=5)
    torch.save(bise.state_dict(), d / "bisenet.pth")
    net = init_params(FaceReconCoeffNet(device="cpu"), seed=6)
    torch.save({("net_recon." if k.startswith("final_layers.") else "net_recon.backbone.") + k: v
                for k, v in net.state_dict().items()}, d / "d3dfr.pth")
    return d


def _argv(files, *extra):
    return ["--device", "cpu", "--ckpt", str(files / "last.ckpt"), *COMMON,
            "--bisenet-ckpt", str(files / "bisenet.pth"),
            "--d3dfr-ckpt", str(files / "d3dfr.pth"), *extra]


def _args(argv):
    """The driver's flags, as cli.swap parses them."""
    return pswap.build_parser().parse_args(["--source", "s", "--target", "t", "--outdir", "o",
                                            *argv])


def _recorded(monkeypatch, cls, zeros):
    """Patch cls.swap_guided to record its keywords and return zeros."""
    seen = {}

    def swap_guided(self, **kw):
        seen.update(kw)
        return zeros(kw["target_image"])

    monkeypatch.setattr(cls, "swap_guided", swap_guided)
    return seen


def test_guided_towers_match_the_jax_driver(files, monkeypatch, tmp_path):
    """The seg and exp functions each driver hands to swap_guided, built from
    the same files, on the same 64 px image: BiSeNet's 19 logits at 256 px
    (|logit| <= 3) within 1e-4 (seen 6.2e-6; fp32 both sides, summation
    order only) and D3DFR's 64 expression coefficients within 1e-4 (seen
    9.5e-7); the terms, weights and scale as given."""
    import jax
    import jax.numpy as jnp

    from reface_tpu.cli import swap as jswap
    from reface_tpu.pipelines.swap import FaceSwapper as JSwapper
    from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny

    argv = ["--source", str(files / "src" / "a.png"), "--target", str(files / "tgt" / "b.png"),
            "--precropped", "--guidance", "id,seg,exp", "--guidance-scale", "0.5",
            "--seg-guidance-weight", "3"]
    jseen = _recorded(monkeypatch, JSwapper, lambda t: jnp.zeros_like(t))
    pseen = _recorded(monkeypatch, PSwapper, lambda t: torch.zeros(t.shape))
    # the JAX driver's swapper goes unused (its swap_guided records): a bare
    # one with the tiny config skips the jitted init of its towers (~20 s)
    stub = object.__new__(JSwapper)
    stub.config = j_tiny()
    monkeypatch.setattr(jswap, "build_swapper", lambda args: stub)
    jswap.main([*argv, "--outdir", str(tmp_path / "j"), "--backend", "cpu", "--tiny",
                "--bisenet-ckpt", str(files / "bisenet.pth"),
                "--d3dfr-ckpt", str(files / "d3dfr.pth")])
    pswap.main([*argv, "--outdir", str(tmp_path / "p"), *_argv(files)])
    for k in ("guidance", "guidance_scale", "id_weight", "seg_weight", "exp_weight"):
        assert tuple(np.atleast_1d(jseen[k])) == tuple(np.atleast_1d(pseen[k])), k
    assert pseen["guidance"] == ("id", "seg", "exp") and pseen["seg_weight"] == 3.0
    img = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    with torch.no_grad():
        seg = pseen["seg_logits_fn"](x).permute(0, 2, 3, 1).numpy()
        exp = pseen["exp_coeff_fn"]((x + 1) / 2).numpy()
    jseg = np.asarray(jax.jit(jseen["seg_logits_fn"])(jnp.asarray(img)))
    jexp = np.asarray(jax.jit(jseen["exp_coeff_fn"])((jnp.asarray(img) + 1) / 2))
    assert seg.shape == jseg.shape == (2, 256, 256, 19) and exp.shape == jexp.shape == (2, 64)
    np.testing.assert_allclose(seg, jseg, atol=1e-4, rtol=0)
    np.testing.assert_allclose(exp, jexp, atol=1e-4, rtol=0)


def test_guided_precropped_is_swap_guided(files):
    """--precropped --guidance id,seg,exp: the PNG within one level of
    swap_guided called directly on the driver's swapper, towers, inputs and
    generator; it moved away from the unguided swap."""
    from reface_tpu_torch.cli.common import default_inpaint_mask
    from reface_tpu_torch.pipelines.swap import clip_normalize

    argv = _argv(files, "--guidance", "id,seg,exp")
    done = pswap.main(["--source", str(files / "src" / "a.png"), "--target",
                       str(files / "tgt" / "b.png"), "--outdir", str(files / "pre"),
                       "--precropped", *argv])
    got = imread(done[0][0]).astype(int)
    args = _args(argv)
    swapper = build_swapper(args)
    seg_fn, exp_fn = pswap.guidance_towers(args, ("seg", "exp"), swapper.device)
    src = torch.from_numpy(pswap._read01(str(files / "src" / "a.png"))[None])
    ref = clip_normalize(src.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    tgt = pswap._read01(str(files / "tgt" / "b.png"), 64)[None] * 2 - 1
    mask = default_inpaint_mask(64)[None]
    kw = dict(target_image=tgt, inpaint_image=tgt * mask, inpaint_mask=mask, ref_clip224=ref)
    want = swapper.swap_guided(**kw, generator=torch.Generator().manual_seed(3),
                               guidance=("id", "seg", "exp"), seg_logits_fn=seg_fn,
                               exp_coeff_fn=exp_fn)[0].numpy()
    plain = swapper.swap(**kw, generator=torch.Generator().manual_seed(3))[0].numpy()
    assert got.shape == (64, 64, 3)
    assert np.abs(got - (want + 1) / 2 * 255).max() <= 1.0
    assert np.abs(want - plain).max() > 0.05


def test_guided_raw_mode_is_the_pipeline(files):
    """The raw mode with --guidance id: every swap is swap_guided, called by
    RawSwapPipeline from inside inference mode; the file within one level
    of the pipeline called directly on the guided swapper."""
    argv = _argv(files, "--guidance", "id")
    pswap.main(["--source", str(files / "src" / "a.png"), "--target",
                str(files / "tgt" / "b.png"), "--outdir", str(files / "raw"), *argv])
    got = imread(files / "raw" / "a_b.png").astype(int)
    from reface_tpu_torch.pipelines.raw import tiny_raw_config

    args = _args(argv)
    swapper = build_swapper(args)
    pswap.use_guidance(args, ("id",), swapper)
    calls = []
    guided = swapper.swap
    swapper.swap = lambda **kw: calls.append(torch.is_inference_mode_enabled()) or guided(**kw)
    pipe = build_raw_pipeline(args, swapper, tiny_raw_config())
    want = pipe.swap_images(pswap._read01(files / "tgt" / "b.png")[None],
                            pswap._read01(files / "src" / "a.png")[None],
                            generator=torch.Generator().manual_seed(3))[0].numpy()
    assert calls == [True] and got.shape == (80, 80, 3)
    assert np.abs(got - want * 255).max() <= 1.0


@pytest.mark.parametrize("extra,message", [
    (["--guidance", "id", "--fused"], "--fused cannot be combined with --guidance"),
    (["--guidance", "id,pose"], "unknown --guidance terms"),
])
def test_guided_refusals(files, extra, message):
    with pytest.raises(SystemExit, match=message):
        pswap.main(["--source", "a", "--target", "b", "--outdir", "o", *extra, *_argv(files)])


# ------------------------------------------------------------- make-priors

class _Unused:
    """A FaceSwapper class that builds nothing."""

    def __init__(self, *args):
        pass

    @staticmethod
    def init_params(*args):
        return None


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A CelebA-style test bench of 2 pairs (128 px JPEGs, 64 px masks), and
    make-priors' directories: each pair's target under targets/{tid}.jpg and
    its source under sources/{tid}.png (the i-th sorted of each paired), a
    JPEG target at another size, and white-is-face masks under each
    target's stem with .png, the second also under its .jpg name."""
    from reface_tpu_torch.data import TestBenchConfig
    from reface_tpu_torch.data.synthetic import face_like

    root = tmp_path_factory.mktemp("priors")
    cfg = TestBenchConfig(str(root / "celeba"), "celeba", image_size=64, num_pairs=2)
    rng = np.random.default_rng(4)
    for d in ("targets", "sources", "masks"):
        (root / d).mkdir()
    for k, (tid, sid) in enumerate(cfg.pair_ids()):
        for i in (tid, sid):
            img, m19 = face_like(rng, 128)
            for path, arr in ((cfg.img_path(i), img), (cfg.mask_path(i), m19[::2, ::2])):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                imwrite(path, arr)
        t_img = imread(cfg.img_path(tid))
        imwrite(root / "targets" / f"{tid}.jpg", t_img if k else t_img[:96, :96])
        imwrite(root / "sources" / f"{tid}.png", imread(cfg.img_path(sid)))
        face = ((imread(cfg.mask_path(tid), gray=True) > 0) * 255).astype(np.uint8)
        imwrite(root / "masks" / f"{tid}.png", face)
        if k:  # found under the .jpg target's own basename before the .png
            imwrite(root / "masks" / f"{tid}.jpg", face)
    return root, cfg


def _priors_argv(root, out, *extra):
    return ["make-priors", "--target-dir", str(root / "targets"), "--source-dir",
            str(root / "sources"), "--mask-dir", str(root / "masks"), "--out-dir", str(out),
            "--size", "64", "--tiny", "--grid", "16", *extra]


def test_make_priors_wiring_matches_jax(tree, monkeypatch, tmp_path):
    """Both drivers with their prior functions patched to record their
    inputs and return the target: the same pairs, the same [-1, 1] target
    and source at --size (a 96 px target brought to 64 by cv2's and
    io/images.py's INTER_LINEAR, bit-equal on uint8), the same mask from
    the basename or the .png fallback (INTER_NEAREST), bit for bit, and the
    same files."""
    import reface_tpu.pipelines.swap as JSwapMod
    import reface_tpu.preprocess.priors as JPri
    from reface_tpu.cli import prepare_data as jprep

    import reface_tpu_torch.preprocess.priors as PPri

    root, cfg = tree
    seen = {"jax": [], "port": []}

    def recorder(name, to_np):
        def prior(tgt, src, t_lm, s_lm, mask):
            seen[name].append([to_np(a) for a in (tgt, src, mask)])
            return tgt
        return prior

    monkeypatch.setattr(JPri, "landmark_tps_prior", recorder("jax", np.asarray))
    monkeypatch.setattr(PPri, "landmark_tps_prior", recorder("port", lambda a: a.numpy()))
    # the JAX driver builds a swapper that --method tps never reads: a bare
    # class skips the jitted init of its towers (~25 s)
    monkeypatch.setattr(JSwapMod, "FaceSwapper", _Unused)
    jprep.main(_priors_argv(root, tmp_path / "j", "--backend", "cpu"))
    pprep.main(_priors_argv(root, tmp_path / "p", "--device", "cpu"))
    assert len(seen["jax"]) == len(seen["port"]) == 2
    for js, ps in zip(seen["jax"], seen["port"]):
        for a, b in zip(js, ps):
            np.testing.assert_array_equal(b, a)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j")) == sorted(
        f"{t}.jpg" for t, _ in cfg.pair_ids())


@pytest.mark.parametrize("method", ["tps", "dift"])
def test_make_priors_methods(tree, tmp_path, method):
    """make-priors --method tps (a seeded tiny LandmarkNet) and dift (the
    tiny swap UNet's features, grid 16): a prior per pair, equal to its
    target outside the mask within one level (the [-1, 1] round trip's
    truncation; the targets here are 64 px PNGs); the DIFT prior equal to dift_prior called
    directly on the driver's towers and draws."""
    from reface_tpu_torch.preprocess.priors import dift_prior, make_unet_feats_fn
    from reface_tpu_torch.pipelines.swap import tiny_swap_config

    root, cfg = tree
    targets = tmp_path / "targets"
    targets.mkdir()
    for t, _ in cfg.pair_ids():  # PNG targets at the size: a lossless prior
        imwrite(targets / f"{t}.png", imread(cfg.img_path(t))[::2, ::2])
    argv = _priors_argv(root, tmp_path / "out", "--method", method, "--device", "cpu")
    argv[argv.index("--target-dir") + 1] = str(targets)
    done = pprep.main(argv)
    assert [os.path.basename(p) for p, _ in done] == [f"{t}.png" for t, _ in cfg.pair_ids()]
    for (path, secs), (t, _) in zip(done, cfg.pair_ids()):
        prior, tgt = imread(path).astype(int), imread(targets / f"{t}.png").astype(int)
        mask = imread(root / "masks" / f"{t}.png", gray=True) > 127
        assert np.abs(prior - tgt)[~mask].max() <= 1 and secs > 0
        assert np.abs(prior - tgt)[mask].max() > 10
        if method == "dift":
            swapper = PSwapper(tiny_swap_config(image_size=64), device="cpu")
            pm1 = lambda a: torch.from_numpy(a.astype(np.float32) / 127.5 - 1.0)
            src = resize_linear(imread(root / "sources" / f"{t}.png"), 64, 64)
            want = dift_prior(pm1(tgt.astype(np.uint8)), pm1(src),
                              torch.from_numpy(mask.astype(np.float32))[..., None],
                              make_unet_feats_fn(swapper), grid=16)
            u8 = np.clip((want.numpy() + 1) * 127.5, 0, 255).astype(np.uint8)
            np.testing.assert_array_equal(prior, u8)


def test_test_bench_reads_the_dift_priors(tree, tmp_path):
    """cli.inference_test_bench --prior-dir on make-priors' DIFT output:
    every PNG within one level of FaceSwapper.swap(prior_image=...) called
    directly on the dataset's batch with the driver's generator."""
    from reface_tpu_torch.cli import inference_test_bench as ptb
    from reface_tpu_torch.data import TestBenchDataset, collate
    import dataclasses

    root, cfg = tree
    pprep.main(_priors_argv(root, tmp_path / "priors", "--method", "dift", "--device", "cpu"))
    model = ["--device", "cpu", "--tiny", "--seed", "5"]
    ptb.main([*model, "--dataset-dir", cfg.dataset_dir, "--dataset", "celeba",
              "--outdir", str(tmp_path / "out"), "--n-samples", "2", "--num-pairs", "2",
              "--prior-dir", str(tmp_path / "priors")])
    ds = TestBenchDataset(dataclasses.replace(cfg, prior_dir=str(tmp_path / "priors")))
    batch = collate([ds[i] for i in range(len(ds))])
    swapper = build_swapper(_args(model))
    want = swapper.swap(target_image=batch["target_image"], inpaint_image=batch["inpaint_image"],
                        inpaint_mask=batch["inpaint_mask"], ref_clip224=batch["ref_clip224"],
                        generator=torch.Generator().manual_seed(5),
                        prior_image=batch["prior_image"]).numpy()
    no_prior = swapper.swap(target_image=batch["target_image"],
                            inpaint_image=batch["inpaint_image"],
                            inpaint_mask=batch["inpaint_mask"], ref_clip224=batch["ref_clip224"],
                            generator=torch.Generator().manual_seed(5)).numpy()
    for i, (tid, sid) in enumerate(ds.pairs):
        got = imread(tmp_path / "out" / "results" / f"{sid}_{tid}.png").astype(int)
        assert np.abs(got - (want[i] + 1) * 127.5).max() <= 1.0
    assert np.abs(want - no_prior).max() > 0.05
