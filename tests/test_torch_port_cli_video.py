"""The port's video driver (reface_tpu_torch/cli/video_swap.py), run as users
run it, on the CPU at --tiny.

The driver reads a PNG AVI that cv2 writes (11 frames; frames without a
face among them), swaps it in batches of --frame-batch 4 (the last batch of
3 padded to 4 by repeating its last frame), and writes swapped.avi, the
frames as PNGs (--frames-dir) and inv_transforms.npy. It is held to the
port's own RawSwapPipeline.swap_images_robust, called batch by batch with
the JAX driver's padding, the fallback state carried and one generator
from the same seed, as test_torch_port_cli_swap.py holds the raw mode:
each frame within one level of 255, the quads within 1e-5.
tests/test_torch_port_raw.py holds swap_images_robust to the JAX package.

Face presence comes from the frames (bright frames hold a face), patched
into RawSwapPipeline, as test_torch_port_raw.py forces its pattern: the
tiny random BiSeNet finds no face to speak of.
"""

import argparse

import cv2
import numpy as np
import pytest
import torch

from test_torch_port_ckpt import WIDE_ARCFACE, _lightning, _towers

from test_torch_port_helpers import one_torch_thread

from reface_tpu_torch.io.images import imread, imwrite
from reface_tpu_torch.io.video import read_frames
from reface_tpu_torch.pipelines.raw import RawSwapPipeline

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

COMMON = ["--tiny", "--weights-dtype", "float32", "--seed", "3",
          "--overrides", "sample_posterior=False", WIDE_ARCFACE]
# bright frames hold a face: frame 0 passes through, 4-5 and 9 take the
# last good frame's swap (5 across no batch edge, 4 across one)
FACES = [0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 1]
BATCH = 4


def _presence(self, t, min_area_frac=2e-3):
    return torch.as_tensor(t).mean(dim=(1, 2, 3)) > 0.5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("video")
    torch.save(_lightning(_towers(seed=11)), d / "last.ckpt")
    rng = np.random.default_rng(0)
    imwrite(d / "a.png", rng.integers(0, 256, (72, 72, 3), dtype=np.uint8))
    w = cv2.VideoWriter(str(d / "in.avi"), cv2.VideoWriter_fourcc(*"png "), 12.0, (96, 80))
    for face in FACES:
        f = rng.integers(0, 128, (80, 96, 3), dtype=np.uint8) + (127 if face else 0)
        w.write(f.astype(np.uint8))
    w.release()
    return d


def test_driver_matches_swap_images_robust(files, monkeypatch):
    from reface_tpu_torch.cli import video_swap
    from reface_tpu_torch.cli.common import add_model_args, build_raw_pipeline, build_swapper
    from reface_tpu_torch.pipelines.raw import tiny_raw_config

    monkeypatch.setattr(RawSwapPipeline, "face_presence", _presence)
    argv = ["--device", "cpu", "--ckpt", str(files / "last.ckpt"), *COMMON]
    out = files / "out"
    res = video_swap.main(["--video", str(files / "in.avi"), "--source", str(files / "a.png"),
                           "--outdir", str(out), "--frame-batch", str(BATCH), "--frames-dir",
                           str(out / "frames"), "--bench-json", *argv])
    got, fps = read_frames(out / "frames")
    assert res["frames"] == len(got) == len(FACES) and res["fps"] == 12.0
    cap = cv2.VideoCapture(str(out / "swapped.avi"))
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == len(FACES) and cap.get(cv2.CAP_PROP_FPS) == 12.0

    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--bisenet-ckpt", default=None)
    args = ap.parse_args(argv)
    sw = build_swapper(args)
    assert res["bench"]["metric"] == f"video_frames_per_sec_ddim{sw.config.ddim_steps}_batch4"
    pipe = build_raw_pipeline(args, sw, tiny_raw_config())
    frames, _ = read_frames(files / "in.avi")
    src = imread(files / "a.png").astype(np.float32)[None] / 255.0
    src_b = np.repeat(src, BATCH, axis=0)
    ref224 = pipe._source_reference(src_b)
    gen = torch.Generator().manual_seed(3)
    state, want, quads = None, [], []
    for i in range(0, len(frames), BATCH):
        arr = np.stack(frames[i: i + BATCH]).astype(np.float32) / 255.0
        n = len(arr)
        arr = np.concatenate([arr, np.repeat(arr[-1:], BATCH - n, axis=0)])
        o, state, q = pipe.swap_images_robust(arr, src_b, generator=gen, state=state,
                                              ref224=ref224)
        want += list(o[:n].numpy())
        quads += list(q[:n])
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.abs(g.astype(int) - np.clip(w * 255, 0, 255).astype(np.uint8)).max() <= 1, k
    np.testing.assert_array_equal(got[0], frames[0])  # before any face: passed through
    inv = np.load(out / "inv_transforms.npy")
    assert inv.shape == (len(FACES), 4, 2)
    np.testing.assert_allclose(inv, np.stack(quads), atol=1e-5, rtol=0)
    # a frame without a face is the last good frame swapped again (its own
    # draw of the noise): that frame's quad, its pixels outside the paste
    for k, good in ((4, 3), (5, 3), (9, 8)):  # 4: across a batch edge
        np.testing.assert_array_equal(inv[k], inv[good])
        kept = (got[good] == frames[good]).all(-1)
        assert 0.2 < kept.mean() < 1.0
        np.testing.assert_array_equal(got[k][kept], frames[good][kept])
        assert np.abs(got[k].astype(int) - frames[k]).mean() > 20


def test_driver_defaults(monkeypatch):
    """The implicit DDIM-30 of the video protocol, unless a config or
    overrides give the steps; --bench-ram implies --bench-json; the device
    defaults to the card."""
    from reface_tpu_torch.cli import video_swap

    seen = []

    def stop(args):
        seen.append(args)
        raise RuntimeError("stop")

    monkeypatch.setattr(video_swap, "build_swapper", stop)
    base = ["--video", "v", "--source", "s", "--outdir", "o"]
    for extra, steps in (([], 30), (["--overrides", "cfg_scale=2"], None),
                         (["--ddim-steps", "12"], 12), (["--bench-ram"], 30)):
        with pytest.raises(RuntimeError, match="stop"):
            video_swap.main(base + extra)
        assert seen[-1].ddim_steps == steps and seen[-1].device == "cuda"
        assert seen[-1].frame_batch == 10 and seen[-1].frames == 0
    assert seen[-1].bench_json
    args = video_swap.build_parser().parse_args(base + ["--eager-video", "--landmark-ckpt", "x"])
    assert video_swap.bench_metric(args, 30) == "video_frames_per_sec_ddim30_batch10_eager_cnnckpt"
