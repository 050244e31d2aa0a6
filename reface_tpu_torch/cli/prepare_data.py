"""Dataset preparation tools (port of reface_tpu/cli/prepare_data.py).

Functional parity targets:
  - merge-celeba-masks: /root/reference/process_CelebA_mask.py — merge
    CelebAMask-HQ per-class PNGs ({id//2000}/{id:05d}_{class}.png) into a
    single 19-class Overall_mask/{id}.png (what data/celeba.py reads).
  - estimate-ffhq-masks: /root/reference/esitmate_FFHQ_mask.py — run the
    BiSeNet parser over FFHQ images512 and save 19-class masks (on the card
    unless --device cpu).
  - crop-and-mask: /root/reference/Crop_and_mask.py — align an id range to
    crops and parse their masks through RawSwapPipeline's stages (the eval
    crops the test bench reads).
  - expand-sd-checkpoint: modify_checkpoints.py — zero-pad an SD-1.4
    conv_in from 4 to 9 input channels, REFace's starting point.
  - make-priors: the reference's scripts/make_priors.py — prior images for
    the test bench's start from the target (`inference_test_bench
    --prior-dir`), by DIFT feature correspondence over the swap UNet or by a
    68-landmark TPS warp (preprocess/priors.py), on the card unless
    --device cpu.

Images are read and written through io/images.py, not cv2.

Usage:
  python -m reface_tpu_torch.cli.prepare_data merge-celeba-masks --dataset-dir D
  python -m reface_tpu_torch.cli.prepare_data estimate-ffhq-masks --dataset-dir D \\
      --bisenet-ckpt 79999_iter.pth [--batch 8]
  python -m reface_tpu_torch.cli.prepare_data make-priors --target-dir T \\
      --source-dir S --mask-dir M --out-dir P --method dift --ckpt last.ckpt
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from reface_tpu_torch.data.synthetic import CELEBA_CLASS_SUFFIXES
from reface_tpu_torch.io.images import imread, imwrite
from reface_tpu_torch.ops.resize import resize_bilinear_aa


def merge_celeba_masks(dataset_dir: str, count: int = 30000) -> None:
    mask_root = os.path.join(dataset_dir, "CelebA-HQ-mask")
    out_dir = os.path.join(mask_root, "Overall_mask")
    os.makedirs(out_dir, exist_ok=True)
    for idx in range(count):
        folder = os.path.join(mask_root, str(idx // 2000))
        overall = None
        for cls_id, suffix in enumerate(CELEBA_CLASS_SUFFIXES, start=1):
            p = os.path.join(folder, f"{idx:05d}_{suffix}.png")
            if not os.path.exists(p):
                continue
            m = imread(p, gray=True)
            if overall is None:
                overall = np.zeros_like(m, np.uint8)
            overall[m > 127] = cls_id
        if overall is not None:
            imwrite(os.path.join(out_dir, f"{idx}.png"), overall)
        if idx % 1000 == 0:
            print(f"[merge] {idx}/{count}")


def estimate_ffhq_masks(dataset_dir: str, bisenet_ckpt: str | None, batch: int = 8,
                        allow_random: bool = False, device=None) -> None:
    from reface_tpu_torch.nn.bisenet import BiSeNet, BiSeNetConfig, parse_faces
    from reface_tpu_torch.pipelines.swap import init_params, resolve_device

    dev = resolve_device(device)
    model = BiSeNet(BiSeNetConfig(), device=dev)
    if bisenet_ckpt:
        from reface_tpu_torch.ckpt.from_torch import bisenet_state_dict, load_torch_state_dict

        model.load_state_dict(bisenet_state_dict(load_torch_state_dict(bisenet_ckpt)))
    elif allow_random:
        init_params(model, seed=0)
    else:
        raise SystemExit("--bisenet-ckpt required (or --allow-random)")
    model.eval().requires_grad_(False)

    img_dir = os.path.join(dataset_dir, "images512")
    out_dir = os.path.join(dataset_dir, "BiSeNet_mask")
    os.makedirs(out_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(img_dir, "*.png")))
    for i in range(0, len(paths), batch):
        chunk = paths[i:i + batch]
        imgs = np.stack([imread(p) for p in chunk]).astype(np.float32) / 255.0
        x = torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2)
        with torch.inference_mode():
            masks = parse_faces(model, x).cpu().numpy()
        for p, m in zip(chunk, masks):
            imwrite(os.path.join(out_dir, os.path.basename(p)), m.astype(np.uint8))
        print(f"[ffhq-masks] {min(i + batch, len(paths))}/{len(paths)}")


def crop_and_mask(dataset_dir: str, out_dir: str, start: int, count: int,
                  allow_random: bool = False, landmark_ckpt: str | None = None,
                  bisenet_ckpt: str | None = None, batch: int = 4, device=None) -> None:
    """Align + mask an id range (Crop_and_mask.py parity: the 29000-30000
    eval source set) with the raw pipeline's detect, align and parse stages,
    on LandmarkNet and BiSeNet weights from the given files (seeded random
    ones with --allow-random)."""
    from reface_tpu_torch.ckpt.from_torch import bisenet_state_dict, load_torch_state_dict
    from reface_tpu_torch.pipelines.raw import RawPipelineConfig, RawSwapPipeline
    from reface_tpu_torch.pipelines.swap import FaceSwapper, resolve_device, tiny_swap_config

    if not (allow_random or (landmark_ckpt and bisenet_ckpt)):
        raise SystemExit("need --landmark-ckpt + --bisenet-ckpt (or --allow-random)")
    dev = resolve_device(device)
    raw_cfg = RawPipelineConfig()
    # only the detection/alignment/parsing stages are used
    pipe = RawSwapPipeline(
        FaceSwapper(tiny_swap_config(), device=dev), raw_cfg,
        landmark_params=load_torch_state_dict(landmark_ckpt) if landmark_ckpt else None,
        bisenet_params=(bisenet_state_dict(load_torch_state_dict(bisenet_ckpt), raw_cfg.bisenet)
                        if bisenet_ckpt else None),
        device=dev)
    os.makedirs(os.path.join(out_dir, "crops"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "masks"), exist_ok=True)
    ids = list(range(start, start + count))
    for i in range(0, len(ids), batch):
        chunk = ids[i:i + batch]
        arr = np.stack([imread(os.path.join(dataset_dir, "CelebA-HQ-img", f"{idx}.jpg"))
                        for idx in chunk]).astype(np.float32) / 255.0
        crops, _ = pipe.align(arr, pipe.detect_landmarks(arr))
        seg = pipe.parse(crops).cpu().numpy()
        crops = crops.cpu().numpy()
        for j, idx in enumerate(chunk):
            u8 = np.clip(crops[j] * 255, 0, 255).astype(np.uint8)
            imwrite(os.path.join(out_dir, "crops", f"{idx}.png"), u8)
            imwrite(os.path.join(out_dir, "masks", f"{idx}.png"), seg[j].astype(np.uint8))
        print(f"[crop-and-mask] {min(i + batch, len(ids))}/{len(ids)}")


def _swap_params(cfg, path: str) -> dict:
    """The towers' state dicts from a REFace last.ckpt, a --save-params file
    or a cli.train checkpoint directory (ckpt/io.py)."""
    from reface_tpu_torch.ckpt import io as ckpt_io
    from reface_tpu_torch.ckpt.from_torch import load_swap_params

    if os.path.isdir(path):
        return ckpt_io.load_params(path)
    return load_swap_params(cfg, path)


def make_priors(target_dir: str, source_dir: str, mask_dir: str, out_dir: str,
                method: str = "tps", grid: int = 128, size: int = 512, tiny: bool = False,
                ckpt: str | None = None, landmark_ckpt: str | None = None,
                device=None) -> list:
    """make_priors.py parity: prior images for the start from the target.

    Pairs the i-th (sorted) target with the i-th source (the reference pairs
    tar_start+i with src_start+i over pre-cropped dirs, make_priors.py:
    33-52); the target's mask (white = face) has the target's basename in
    mask_dir, or its stem with .png. method "dift": argmax-cosine
    correspondence over the swap UNet's own features at t=261 (the
    reference's DIFT mechanism) on a grid^2 lattice; "tps": a 68-landmark
    TPS warp from LandmarkNet's points. The swap towers (dift) come from
    --ckpt, else seeded at random; LandmarkNet (tps) from --landmark-ckpt (a
    torch file of its state dict), else seeded. Each prior is written under
    the target's basename. Returns [(output path, seconds)] per pair."""
    import time

    from reface_tpu_torch.io.images import resize_linear, resize_nearest
    from reface_tpu_torch.pipelines.swap import (
        FaceSwapper,
        SwapConfig,
        init_params,
        resolve_device,
        tiny_swap_config,
    )
    from reface_tpu_torch.preprocess.priors import (
        dift_prior,
        landmark_tps_prior,
        make_unet_feats_fn,
    )

    def listing(d):
        out = []
        for ext in ("*.png", "*.jpg", "*.jpeg"):
            out += glob.glob(os.path.join(d, ext))
        return sorted(out)

    targets, sources = listing(target_dir), listing(source_dir)
    n = min(len(targets), len(sources))
    if n == 0:
        raise SystemExit("no image pairs found")
    dev = resolve_device(device)

    feats_fn = landmark_fn = None
    if method == "dift":
        cfg = tiny_swap_config(image_size=size) if tiny else SwapConfig(image_size=size)
        swapper = FaceSwapper(cfg, _swap_params(cfg, ckpt) if ckpt else None, device=dev)
        feats_fn = make_unet_feats_fn(swapper)
    else:
        from reface_tpu_torch.ckpt.from_torch import load_torch_state_dict
        from reface_tpu_torch.nn.landmarks import LandmarkNet, LandmarkNetConfig

        lm_cfg = LandmarkNetConfig() if not tiny else LandmarkNetConfig(
            widths=(8, 16, 32, 32), input_size=64, dtype=torch.float32)
        net = LandmarkNet(lm_cfg, device=dev)
        if landmark_ckpt:
            net.load_state_dict(load_torch_state_dict(landmark_ckpt))
        else:
            init_params(net, seed=1)
        net.eval().requires_grad_(False)

        @torch.inference_mode()
        def landmark_fn(img01):
            s = lm_cfg.input_size
            x = resize_bilinear_aa(img01.permute(2, 0, 1)[None], s, s) * 2 - 1
            return net(x).reshape(68, 2) * (img01.shape[0] / s)

    os.makedirs(out_dir, exist_ok=True)
    done = []
    for i in range(n):
        t0 = time.perf_counter()
        t_im, s_im = imread(targets[i]), imread(sources[i])
        if t_im.shape[0] != size:
            t_im = resize_linear(t_im, size, size)
        if s_im.shape[0] != size:
            s_im = resize_linear(s_im, size, size)
        mp = os.path.join(mask_dir, os.path.basename(targets[i]))
        mp = mp if os.path.exists(mp) else os.path.splitext(mp)[0] + ".png"
        if not os.path.exists(mp):
            raise SystemExit(f"mask not found for {targets[i]}")
        m = imread(mp, gray=True)
        if m.shape[0] != size:
            m = resize_nearest(m, size, size)
        on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        mask = on_dev((m > 127).astype(np.float32))[..., None]
        tgt = on_dev(t_im.astype(np.float32) / 127.5 - 1.0)
        src = on_dev(s_im.astype(np.float32) / 127.5 - 1.0)
        if method == "dift":
            prior = dift_prior(tgt, src, mask, feats_fn, grid=grid)
        else:
            t_lm = landmark_fn(on_dev(t_im.astype(np.float32) / 255.0))
            s_lm = landmark_fn(on_dev(s_im.astype(np.float32) / 255.0))
            prior = landmark_tps_prior(tgt, src, t_lm, s_lm, mask)
        u8 = np.clip((prior.cpu().numpy() + 1) * 127.5, 0, 255).astype(np.uint8)
        path = os.path.join(out_dir, os.path.basename(targets[i]))
        imwrite(path, u8)
        done.append((path, time.perf_counter() - t0))
        if (i + 1) % 10 == 0 or i == n - 1:
            print(f"[make-priors:{method}] {i + 1}/{n}")
    return done


def expand_sd_checkpoint(src: str, dst: str) -> None:
    """modify_checkpoints.py parity: 4->9 channel conv_in zero-pad."""
    from reface_tpu_torch.ckpt.from_torch import expand_conv_in, load_torch_state_dict

    sd = expand_conv_in(load_torch_state_dict(src))
    torch.save({"state_dict": sd}, dst)
    print(f"[expand] wrote {dst}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    device_help = "run on the card (default; raises without one) or the CPU"
    m = sub.add_parser("merge-celeba-masks")
    m.add_argument("--dataset-dir", required=True)
    m.add_argument("--count", type=int, default=30000)
    e = sub.add_parser("estimate-ffhq-masks")
    e.add_argument("--dataset-dir", required=True)
    e.add_argument("--bisenet-ckpt", default=None)
    e.add_argument("--batch", type=int, default=8)
    e.add_argument("--allow-random", action="store_true")
    e.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)
    x = sub.add_parser("expand-sd-checkpoint")
    x.add_argument("--src", required=True)
    x.add_argument("--dst", required=True)
    p = sub.add_parser("make-priors")
    p.add_argument("--target-dir", required=True)
    p.add_argument("--source-dir", required=True)
    p.add_argument("--mask-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--method", default="tps", choices=["tps", "dift"])
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--ckpt", default=None,
                   help="swap params: a REFace last.ckpt, a --save-params file or a "
                        "cli.train checkpoint dir (dift features; none = random)")
    p.add_argument("--landmark-ckpt", default=None,
                   help="torch file of a LandmarkNet state dict (tps; none = random)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)
    c = sub.add_parser("crop-and-mask")
    c.add_argument("--dataset-dir", required=True)
    c.add_argument("--out-dir", required=True)
    c.add_argument("--start", type=int, default=29000)
    c.add_argument("--count", type=int, default=1000)
    c.add_argument("--allow-random", action="store_true")
    c.add_argument("--landmark-ckpt", default=None,
                   help="torch file of a LandmarkNet state dict")
    c.add_argument("--bisenet-ckpt", default=None)
    c.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = None if getattr(args, "device", "cuda") == "cuda" else args.device
    if args.cmd == "merge-celeba-masks":
        merge_celeba_masks(args.dataset_dir, args.count)
    elif args.cmd == "estimate-ffhq-masks":
        estimate_ffhq_masks(args.dataset_dir, args.bisenet_ckpt, args.batch,
                            args.allow_random, device)
    elif args.cmd == "expand-sd-checkpoint":
        expand_sd_checkpoint(args.src, args.dst)
    elif args.cmd == "make-priors":
        return make_priors(args.target_dir, args.source_dir, args.mask_dir, args.out_dir,
                           args.method, args.grid, args.size, args.tiny, args.ckpt,
                           args.landmark_ckpt, device=device)
    elif args.cmd == "crop-and-mask":
        crop_and_mask(args.dataset_dir, args.out_dir, args.start, args.count,
                      args.allow_random, args.landmark_ckpt, args.bisenet_ckpt,
                      device=device)


if __name__ == "__main__":
    main()
