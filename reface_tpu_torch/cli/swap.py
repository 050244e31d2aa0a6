"""Single/folder face-swap driver (port of reface_tpu/cli/swap.py).

Loops sources x targets: detect and align, parse, swap, paste back, save
(the reference's one_inference.py folder mode and inference_swap_selected.py).
`--precropped` skips detection and parsing for inputs that are already
aligned, with a keep-mask from `--mask-dir` or a central ellipse. One
torch.Generator on the swapper's device, seeded from --seed, draws every
pair's noise in turn (the JAX package splits keys instead: the two draw
different numbers). An output is named `<source stem>_<target name>`, so a
.jpg target gives a .jpg output.

Usage (on the card; --device cpu --tiny for a smoke run on the CPU):
  python -m reface_tpu_torch.cli.swap --ckpt last.ckpt --source a.jpg \
      --target b.png --outdir out
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from reface_tpu_torch.cli.common import add_model_args, build_swapper
from reface_tpu_torch.io.images import imread, imwrite, resize_linear


def _list_images(path):
    if os.path.isdir(path):
        out = []
        for ext in ("*.png", "*.jpg", "*.jpeg"):
            out += glob.glob(os.path.join(path, ext))
        return sorted(out)
    return [path]


def _read01(path, size=None):
    img = imread(path)
    if size is not None and img.shape[0] != size:
        img = resize_linear(img, size, size)
    return img.astype(np.float32) / 255.0


def _write01(path, img01):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imwrite(path, np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8))


def _out_name(sp, tp):
    return os.path.splitext(os.path.basename(sp))[0] + "_" + os.path.basename(tp)


def main(argv=None):
    """Run the driver; returns [(output path, seconds)] per pair, the
    seconds from reading the pair's target to writing the output (each
    source is read once, before its targets)."""
    ap = argparse.ArgumentParser(description=__doc__)
    add_model_args(ap)
    ap.add_argument("--target", required=True, help="image or folder")
    ap.add_argument("--source", required=True, help="image or folder")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--landmark-ckpt", default=None,
                    help="torch file of a LandmarkNet state dict (on-device landmarks)")
    ap.add_argument("--landmark-rert", default=None,
                    help="native .rert ERT model: exact dlib-parity landmarks "
                         "on the host for align + conditioning (eager path "
                         "only, refused with --fused; use --landmark-ckpt there)")
    ap.add_argument("--bisenet-ckpt", default=None)
    ap.add_argument("--precropped", action="store_true",
                    help="inputs already aligned; skip detect/parse/paste")
    ap.add_argument("--mask-dir", default=None,
                    help="precropped mode: dir of keep-masks (white=keep) "
                         "matching target basenames; default = inpaint a "
                         "central face-shaped ellipse")
    ap.add_argument("--head-swap", action="store_true",
                    help="universal head swap: include hair/accessories")
    ap.add_argument("--guidance", default=None,
                    help="comma list of gradient-guidance terms: id,seg,exp "
                         "(not ported yet: ROADMAP A13)")
    ap.add_argument("--guidance-scale", type=float, default=1.0)
    ap.add_argument("--id-guidance-weight", type=float, default=1.0)
    ap.add_argument("--seg-guidance-weight", type=float, default=10.0)
    ap.add_argument("--exp-guidance-weight", type=float, default=100.0)
    ap.add_argument("--d3dfr-ckpt", default=None,
                    help="D3DFR coeff net for --guidance exp")
    ap.add_argument("--fused", action="store_true",
                    help="latency mode: RawSwapPipeline.swap_images_fused "
                         "(every landmark from LandmarkNet)")
    args = ap.parse_args(argv)
    if args.guidance:
        raise NotImplementedError(
            "--guidance: the gradient-guided swap is not ported yet (ROADMAP A13)")

    from reface_tpu_torch.pipelines.raw import RawPipelineConfig
    from reface_tpu_torch.pipelines.swap import clip_normalize

    swapper = build_swapper(args)
    size = swapper.config.image_size
    dev = swapper.device
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    targets = _list_images(args.target)
    sources = _list_images(args.source)
    done = []

    def nchw(a):
        return torch.from_numpy(a).to(dev).permute(0, 3, 1, 2)

    if args.precropped:
        from reface_tpu_torch.cli.common import decode_keep_mask, default_inpaint_mask

        def keep_mask(tp):
            """The keep-mask file of this target, else the central ellipse."""
            if args.mask_dir:
                mp = os.path.join(args.mask_dir, os.path.basename(tp))
                try:
                    return decode_keep_mask(mp, size)
                except ValueError:
                    raise SystemExit(f"mask not found: {mp}")
            return default_inpaint_mask(size)

        for sp in sources:
            ref = clip_normalize(nchw(_read01(sp)[None])).permute(0, 2, 3, 1)
            for tp in targets:
                t0 = time.perf_counter()
                tgt = _read01(tp, size)[None] * 2 - 1
                mask = keep_mask(tp)[None]
                out = swapper.swap(target_image=tgt, inpaint_image=tgt * mask,
                                   inpaint_mask=mask, ref_clip224=ref, generator=generator)
                path = os.path.join(args.outdir, _out_name(sp, tp))
                _write01(path, (out[0].cpu().numpy() + 1) / 2)
                done.append((path, time.perf_counter() - t0))
                print(f"[swap] {os.path.basename(path)} ({done[-1][1]:.3f} s)")
        return done

    from reface_tpu_torch.cli.common import build_raw_pipeline

    if args.head_swap:
        from reface_tpu_torch.preprocess.masks import HEAD_SWAP_SEG12 as seg12
    else:
        from reface_tpu_torch.pipelines.raw import DEFAULT_SEG12_FACE as seg12
    if args.tiny:
        from reface_tpu_torch.pipelines.raw import tiny_raw_config

        raw_cfg = tiny_raw_config(seg12_face_classes=seg12)
    else:
        raw_cfg = RawPipelineConfig(seg12_face_classes=seg12)
    pipe = build_raw_pipeline(args, swapper, raw_cfg)
    swap_fn = pipe.swap_images_fused if args.fused else pipe.swap_images
    for sp in sources:
        src = _read01(sp)
        for tp in targets:
            t0 = time.perf_counter()
            tgt = _read01(tp)
            out = swap_fn(tgt[None], src[None], generator=generator)
            path = os.path.join(args.outdir, _out_name(sp, tp))
            _write01(path, out[0].cpu().numpy())
            done.append((path, time.perf_counter() - t0))
            print(f"[swap] {os.path.basename(path)} ({done[-1][1]:.3f} s)")
    return done


if __name__ == "__main__":
    main()
