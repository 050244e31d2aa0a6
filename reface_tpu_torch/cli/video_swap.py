"""Video face-swap driver: frame-batched, host-pipelined (port of
reface_tpu/cli/video_swap.py).

Functional parity target: the reference's scripts/inference_swap_video.py +
inference_video_swap.sh — frame decode, per-frame align/parse with the
last-good-frame fallback, one source reference, DDIM-30 scale 3 over frame
batches of 10, paste-back per frame, re-encode (the source's audio muxed
back through ffmpeg where it is on the PATH).

The frames go through RawSwapPipeline.swap_images_robust in batches of
--frame-batch (the last one padded by repeating its last frame), the
fallback state carried from batch to batch; a reader thread decodes and
queues the batches while the card swaps. The video is read by io/video.py:
a directory of PNG/JPEG frames, an MJPEG or PNG AVI, or, where ffmpeg is on
the PATH, any file it decodes. The output is `swapped.avi` (MJPEG, quality
95), `inv_transforms.npy` (each frame's paste-back quad) and, where ffmpeg
is on the PATH, `swapped.mp4` (x264, the source's audio); --frames-dir
also writes every output frame as a PNG.

Usage:
  python -m reface_tpu_torch.cli.video_swap --video in.avi --source face.png \\
      --outdir out [--tiny --device cpu --frames 8]
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from reface_tpu_torch.cli.common import add_model_args, build_swapper

__all__ = ["build_parser", "main", "bench_metric"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(ap)
    ap.add_argument("--video", required=True,
                    help="a directory of PNG/JPEG frames, an MJPEG or PNG AVI, or (with "
                         "ffmpeg on the PATH) any video file")
    ap.add_argument("--source", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--frame-batch", type=int, default=10)
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--landmark-ckpt", default=None,
                    help="torch file of a LandmarkNet state dict (on-device landmarks)")
    ap.add_argument("--landmark-rert", default=None,
                    help="native .rert ERT model: exact dlib-parity landmarks on the "
                         "host for align + conditioning")
    ap.add_argument("--bisenet-ckpt", default=None)
    ap.add_argument("--bench-json", action="store_true",
                    help="print a steady-state frames/s JSON line (first batch excluded)")
    ap.add_argument("--eager-video", action="store_true",
                    help="every landmark from the host landmark function where there is "
                         "one (swap_images_robust(one_program=False)); by default the "
                         "512 px conditioning re-detect is LandmarkNet's")
    ap.add_argument("--bench-ram", action="store_true",
                    help="host-stage bypass bench: decode all frames (up to --frames) "
                         "before the clock starts and write no video (implies "
                         "--bench-json)")
    ap.add_argument("--frames-dir", default=None,
                    help="also write every output frame as a PNG into this directory")
    return ap


def bench_metric(args, ddim_steps: int) -> str:
    """The --bench-json metric's name, the JAX driver's: the resolved step
    count and the frame batch, with _ram, _eager and _ert / _cnnckpt for
    the path measured."""
    metric = f"video_frames_per_sec_ddim{ddim_steps}_batch{args.frame_batch}"
    if args.bench_ram:
        metric += "_ram"
    if args.eager_video:
        metric += "_eager"
    if args.landmark_rert:
        metric += "_ert"
    elif args.landmark_ckpt:
        metric += "_cnnckpt"
    return metric


def _mux(ffmpeg: str, avi: str, video: str, out: str) -> None:
    """swapped.avi re-encoded with x264, the source file's audio (if any)
    muxed back, as the JAX driver's ffmpeg call does."""
    audio = ["-i", video, "-map", "0:v", "-map", "1:a?"] if os.path.isfile(video) else []
    cmd = [ffmpeg, "-y", "-v", "error", "-i", avi, *audio, "-c:v", "libx264", "-c:a", "aac",
           out]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        print(f"[video] WARNING: ffmpeg could not write {out} (exit {done.returncode}): "
              f"{done.stderr.strip()[-400:]}")


def main(argv=None):
    """Run the driver; returns a dict: frames, fps, the output paths, each
    batch's seconds and the --bench-json line's dict (or None)."""
    args = build_parser().parse_args(argv)
    if args.bench_ram:
        args.bench_json = True
    if args.ddim_steps is None and not args.config and not args.overrides:
        # the video protocol's default (inference_video_swap.sh); a config
        # file keeps precedence over this implicit default
        args.ddim_steps = 30

    from reface_tpu_torch.cli.common import build_raw_pipeline
    from reface_tpu_torch.io.images import imread
    from reface_tpu_torch.io.video import VideoReader, VideoWriter
    from reface_tpu_torch.pipelines.raw import RawPipelineConfig, tiny_raw_config

    swapper = build_swapper(args)
    raw_cfg = tiny_raw_config() if args.tiny else RawPipelineConfig()
    pipe = build_raw_pipeline(args, swapper, raw_cfg)

    cap = VideoReader(args.video)
    fps = cap.fps or 25.0
    os.makedirs(args.outdir, exist_ok=True)
    avi_path = os.path.join(args.outdir, "swapped.avi")
    writer = None if args.bench_ram else VideoWriter(avi_path, fps, frames_dir=args.frames_dir)

    ram_frames = None
    if args.bench_ram:
        # decode everything up front so that the timed loop pays no decode
        ram_frames = []
        for frame in cap:
            ram_frames.append(frame)
            if args.frames and len(ram_frames) >= args.frames:
                break
        cap.close()
        print(f"[video] pre-decoded {len(ram_frames)} frames into RAM")

    src01 = imread(args.source).astype(np.float32)[None] / 255.0
    src_b = np.repeat(src01, args.frame_batch, axis=0)
    # the source is the same for the whole video: its CLIP reference is
    # encoded once, not at every batch
    ref224 = pipe._source_reference(src_b)
    generator = torch.Generator(device=swapper.device).manual_seed(args.seed)

    frame_q: queue.Queue = queue.Queue(maxsize=4)
    stop = threading.Event()

    def reader():
        batch, n = [], 0
        try:
            for frame in (ram_frames if ram_frames is not None else cap):
                if stop.is_set():
                    return
                batch.append(frame)
                n += 1
                if len(batch) == args.frame_batch:
                    frame_q.put(batch)
                    batch = []
                if args.frames and n >= args.frames:
                    break
            if batch:
                frame_q.put(batch)
        except Exception as e:  # handed to the main thread, which raises it
            frame_q.put(e)
        finally:
            cap.close()
            frame_q.put(None)

    feeder = threading.Thread(target=reader, daemon=True)
    feeder.start()

    # the last-good-frame fallback state and each frame's inverse transform
    # (inference_swap_video.py:468-500)
    state = None
    inv_transforms: list = []

    def flush(frames):
        nonlocal state
        n = len(frames)
        arr = np.stack(frames).astype(np.float32) / 255.0
        if n < args.frame_batch:  # padded to the batch, as the JAX driver's shape
            arr = np.concatenate([arr, np.repeat(arr[-1:], args.frame_batch - n, axis=0)])
        out, state, quads = pipe.swap_images_robust(
            arr, src_b, generator=generator, state=state,
            one_program=not args.eager_video, ref224=ref224)
        inv_transforms.extend(np.asarray(quads)[:n])
        out = out[:n].cpu().numpy()  # the host readback synchronises the card
        if writer is not None:
            for f in out:
                writer.write(np.clip(f * 255.0, 0, 255).astype(np.uint8))

    count = 0
    batch_s = []
    bench = {"t0": None, "frames": 0}
    try:
        while True:
            batch = frame_q.get()
            if batch is None:
                break
            if isinstance(batch, Exception):
                raise batch
            t0 = time.perf_counter()
            count += len(batch)
            flush(batch)
            batch_s.append(time.perf_counter() - t0)
            # the steady clock starts after the first batch (first use, warm-up)
            if bench["t0"] is None:
                bench["t0"] = time.perf_counter()
            else:
                bench["frames"] += len(batch)
            print(f"[video] {count} frames")
    except BaseException:
        # the reader stops and closes its video (an ffmpeg pipe included)
        stop.set()
        while feeder.is_alive():
            try:
                frame_q.get(timeout=0.1)
            except queue.Empty:
                pass
        if writer is not None:
            writer.abort()
        raise
    line = None
    if args.bench_json:
        metric = bench_metric(args, swapper.config.ddim_steps)
        if bench["frames"]:
            fs = bench["frames"] / (time.perf_counter() - bench["t0"])
            line = {"metric": metric, "value": round(fs, 4), "unit": "frames/s",
                    "note": ("host-stage bypass: pre-decoded RAM frames in, no writer — "
                             "align+parse+swap+paste-back+readback only, first batch "
                             "excluded" if args.bench_ram else
                             "end-to-end decode+align+parse+swap+paste-back+encode, first "
                             "batch excluded")}
        else:
            line = {"metric": metric, "value": None, "unit": "frames/s",
                    "note": "steady-state needs >1 frame batch (the first is excluded); "
                            "give more frames or a smaller --frame-batch"}
        print(json.dumps(line))
    np.save(os.path.join(args.outdir, "inv_transforms.npy"), np.asarray(inv_transforms))
    result = {"frames": count, "fps": fps, "batch_s": batch_s, "bench": line, "avi": None,
              "mp4": None}
    if writer is None:
        print(f"[video] bench-ram done ({count} frames, no output video)")
        return result
    writer.close()
    result["avi"] = avi_path
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg:
        mp4 = os.path.join(args.outdir, "swapped.mp4")
        _mux(ffmpeg, avi_path, args.video, mp4)
        result["mp4"] = mp4 if os.path.exists(mp4) else None
    print(f"[video] wrote {avi_path}{' and ' + result['mp4'] if result['mp4'] else ''} "
          f"({count} frames @ {fps:.2f} fps)")
    return result


if __name__ == "__main__":
    main()
