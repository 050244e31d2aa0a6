"""Single/folder face-swap driver (port of reface_tpu/cli/swap.py).

Loops sources x targets: detect and align, parse, swap, paste back, save
(the reference's one_inference.py folder mode and inference_swap_selected.py).
`--precropped` skips detection and parsing for inputs that are already
aligned, with a keep-mask from `--mask-dir` or a central ellipse. One
torch.Generator on the swapper's device, seeded from --seed, draws every
pair's noise in turn (the JAX package splits keys instead: the two draw
different numbers). An output is named `<source stem>_<target name>`, so a
.jpg target gives a .jpg output. `--guidance id,seg,exp` routes every swap
of both modes through FaceSwapper.swap_guided (the gradient-guided sampler,
ddim_guided.py:380-609 semantics) with fp32 BiSeNet at 256 px for "seg" and
fp32 D3DFR at 224 px for "exp", read from --bisenet-ckpt and --d3dfr-ckpt
(seeded random towers, with a warning, without them).

Usage (on the card; --device cpu --tiny for a smoke run on the CPU):
  python -m reface_tpu_torch.cli.swap --ckpt last.ckpt --source a.jpg \
      --target b.png --outdir out
"""

from __future__ import annotations

import argparse
import functools
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


def guidance_towers(args, terms, device):
    """(seg_logits_fn, exp_coeff_fn) of the --guidance terms, None where a
    term is off: fp32 BiSeNet on the image in [-1,1] brought to [0,1] and
    256 px (SEG_MEAN/SEG_STD normalised; (B,19,256,256) logits), fp32 D3DFR
    on the image in [0,1] at 224 px (coefficients 80:144). The towers are
    frozen; without a checkpoint each is seeded at random, with a warning."""
    from reface_tpu_torch.ckpt.from_torch import (
        bisenet_state_dict,
        facerecon_state_dict,
        load_torch_state_dict,
    )
    from reface_tpu_torch.ops.resize import resize_bilinear_aa
    from reface_tpu_torch.pipelines.swap import init_params

    def tower(module, path, read, what, flag):
        if path:
            module.load_state_dict(read(load_torch_state_dict(path)))
        else:
            print(f"[swap] WARNING: --guidance {what} with random {module.__class__.__name__} "
                  f"(no {flag})")
            init_params(module, seed=0)
        return module.eval().requires_grad_(False)

    seg_fn = exp_fn = None
    if "seg" in terms:
        from reface_tpu_torch.nn.bisenet import SEG_MEAN, SEG_STD, BiSeNet, BiSeNetConfig

        bise = tower(BiSeNet(BiSeNetConfig(dtype=torch.float32), device=device),
                     args.bisenet_ckpt, bisenet_state_dict, "seg", "--bisenet-ckpt")
        r = lambda a: torch.as_tensor(a, device=device).reshape(1, 3, 1, 1)
        mean, std = r(SEG_MEAN), r(SEG_STD)

        def seg_fn(img_pm1):
            # 19-class logits at 256 px (ddim_guided.py:434-456)
            x01 = resize_bilinear_aa((img_pm1 + 1.0) / 2.0, 256, 256)
            return bise((x01 - mean) / std)

    if "exp" in terms:
        from reface_tpu_torch.eval.backbones import FaceReconCoeffNet

        net = tower(FaceReconCoeffNet(device=device), args.d3dfr_ckpt, facerecon_state_dict,
                    "exp", "--d3dfr-ckpt")

        def exp_fn(img01):
            return net(resize_bilinear_aa(img01, 224, 224))[:, 80:144]

    return seg_fn, exp_fn


def guidance_terms(spec: str) -> tuple:
    """The --guidance list as a tuple of terms; an unknown term exits."""
    terms = tuple(t.strip() for t in spec.split(",") if t.strip())
    bad = set(terms) - {"id", "seg", "exp"}
    if bad:
        raise SystemExit(f"unknown --guidance terms: {sorted(bad)}")
    return terms


def use_guidance(args, terms, swapper) -> None:
    """Route every swap of `swapper` (the precropped loop's and the raw
    pipeline's) through swap_guided with the --guidance terms."""
    seg_fn, exp_fn = guidance_towers(args, terms, swapper.device)
    swapper.swap = functools.partial(
        swapper.swap_guided, guidance=terms, guidance_scale=args.guidance_scale,
        id_weight=args.id_guidance_weight, seg_weight=args.seg_guidance_weight,
        exp_weight=args.exp_guidance_weight, seg_logits_fn=seg_fn, exp_coeff_fn=exp_fn)


def build_parser() -> argparse.ArgumentParser:
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
                         "(ddim_guided.py:380-609 semantics)")
    ap.add_argument("--guidance-scale", type=float, default=1.0)
    ap.add_argument("--id-guidance-weight", type=float, default=1.0)
    ap.add_argument("--seg-guidance-weight", type=float, default=10.0,
                    help="seg-L1 over classes 1,11,12,13 (ddim_guided:434-456)")
    ap.add_argument("--exp-guidance-weight", type=float, default=100.0,
                    help="3DMM expression cosine (ddim_guided:460-508)")
    ap.add_argument("--d3dfr-ckpt", default=None,
                    help="D3DFR coeff net for --guidance exp")
    ap.add_argument("--fused", action="store_true",
                    help="latency mode: RawSwapPipeline.swap_images_fused "
                         "(every landmark from LandmarkNet)")
    return ap


def main(argv=None):
    """Run the driver; returns [(output path, seconds)] per pair, the
    seconds from reading the pair's target to writing the output (each
    source is read once, before its targets)."""
    args = build_parser().parse_args(argv)
    if args.guidance and args.fused:
        raise SystemExit("--fused cannot be combined with --guidance: the "
                         "gradient-guided sampler runs eager (per-stage) only")
    terms = guidance_terms(args.guidance) if args.guidance else ()

    from reface_tpu_torch.pipelines.raw import RawPipelineConfig
    from reface_tpu_torch.pipelines.swap import clip_normalize

    swapper = build_swapper(args)
    if terms:
        use_guidance(args, terms, swapper)
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
