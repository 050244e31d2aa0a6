"""First-stage (VAE) fine-tuning with the LPIPS + KL + PatchGAN loss (port of
reface_tpu/cli/train_vae.py).

The driver of diffusion/vae_loss.py: the reference's LPIPSWithDiscriminator
and AutoencoderKL's two-optimizer training (ldm/models/autoencoder.py:
351-418). The VAE keeps fp32 weights and computes in VAEConfig()'s bf16
with decoder remat; the generator pass's encode and decode differentiate
through FlashAttention at the mid-block (d = 512), the discriminator pass's
encode runs K2.

Every flag of the JAX driver keeps its name and default, except that
`--backend` is `--device {cuda,cpu}` (the card unless the CPU is asked for;
raises without a card). --vae-ckpt takes a torch file (the VAE under
`first_stage_model.` in a full SD / REFace checkpoint, detected, or a
standalone dump) or the `<out>/vae` directory this driver wrote; a JAX
(orbax) directory is refused. --images reads png, jpg and jpeg whatever the
case of the extension (the JAX driver globs lowercase ones only), decoded
and resized as PIL's BILINEAR (io/images.py). metrics.jsonl has the JAX
driver's keys; timing.jsonl has each step's seconds (the card synchronised)
and peak memory. The outputs are `<out>/vae` and `<out>/disc`
(ckpt/io.py's params.pt, {"vae": ...} and {"disc": ...}).

Usage:
  python -m reface_tpu_torch.cli.train_vae --images <dir> --out vae_run \\
      --steps 1000 --lpips-ckpt lpips.pth [--vae-ckpt sd.ckpt] \\
      [--disc-start 0] [--device cpu --tiny]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

_EXTENSIONS = (".png", ".jpg", ".jpeg")


def _load_images(folder: str, size: int, limit: int = 0) -> np.ndarray:
    """Folder of images -> (N, size, size, 3) float32 in [-1,1], sorted by
    path, PIL's decode and BILINEAR resize."""
    from reface_tpu_torch.io.images import open_rgb, resize_bilinear_pil

    paths = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                   if not f.startswith(".") and os.path.splitext(f)[1].lower() in _EXTENSIONS
                   and os.path.isfile(os.path.join(folder, f)))
    if limit:
        paths = paths[:limit]
    if not paths:
        raise SystemExit(f"no images in {folder}")
    return np.stack([resize_bilinear_pil(open_rgb(p), size, size).astype(np.float32)
                     / 127.5 - 1.0 for p in paths])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--images", required=True, help="folder of face images")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--vae-ckpt", default=None,
                    help="torch .ckpt/.pth, or the <out>/vae directory this driver "
                         "wrote; default: fresh init")
    ap.add_argument("--lpips-ckpt", default=None,
                    help="LPIPS torch weights; REQUIRED for a meaningful "
                         "perceptual term (random features otherwise)")
    ap.add_argument("--allow-random-lpips", action="store_true")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--max-images", type=int, default=4096,
                    help="cap on images loaded to host RAM (a 256px image "
                         "is ~0.8 MB as float32; 0 = no cap)")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=4.5e-6,
                    help="base lr (autoencoder.py uses lr for both opts)")
    ap.add_argument("--disc-start", type=int, default=50001,
                    help="step after which the GAN term engages "
                         "(contperceptual disc_start)")
    ap.add_argument("--disc-loss", default="hinge", choices=["hinge", "vanilla"])
    ap.add_argument("--kl-weight", type=float, default=1e-6,
                    help="reference first-stage configs use 1e-6")
    ap.add_argument("--disc-weight", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--tiny", action="store_true", help="tiny VAE width (smoke/CI)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) or the CPU")
    return ap


def tiny_vae_config():
    from reface_tpu_torch.nn.vae import VAEConfig

    return VAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1, dtype=torch.float32)


def _vae_params(path: str, vae_cfg) -> tuple[dict, str]:
    """(VAE state dict, what was read) from --vae-ckpt."""
    from reface_tpu_torch.ckpt import io as ckpt_io
    from reface_tpu_torch.ckpt.from_torch import load_torch_state_dict, vae_state_dict
    from reface_tpu_torch.cli.common import refuse_orbax_dir

    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, ckpt_io.PARAMS_FILE)):
            refuse_orbax_dir(path, "--vae-ckpt")
        return ckpt_io.load_params(path)["vae"], f"loaded {path}"
    sd, prefix = vae_state_dict(load_torch_state_dict(path), vae_cfg)
    return sd, f"read torch weights from {path} (prefix={prefix or 'none'})"


def main(argv=None):
    args = build_parser().parse_args(argv)

    from reface_tpu_torch.ckpt.from_torch import load_torch_state_dict, lpips_state_dict
    from reface_tpu_torch.ckpt.io import save_params
    from reface_tpu_torch.cli.common import resolve_device
    from reface_tpu_torch.core.profiling import device_memory_stats
    from reface_tpu_torch.diffusion.vae_loss import VAELossConfig, make_vae_train_step
    from reface_tpu_torch.nn.lpips import LPIPS
    from reface_tpu_torch.nn.vae import AutoencoderKL, VAEConfig
    from reface_tpu_torch.pipelines.swap import init_params

    dev = resolve_device(args)
    cuda = dev.type == "cuda"
    vae_cfg = tiny_vae_config() if args.tiny else VAEConfig(remat=True)
    vae = AutoencoderKL(vae_cfg, device=dev, param_dtype=torch.float32)
    if args.vae_ckpt:
        sd, what = _vae_params(args.vae_ckpt, vae_cfg)
        vae.load_state_dict(sd)
        print(f"[vae] {what}")
    else:
        init_params(vae, seed=args.seed)
        print("[vae] fresh init (no --vae-ckpt)")

    loss_cfg = VAELossConfig(disc_start=args.disc_start, kl_weight=args.kl_weight,
                             disc_weight=args.disc_weight, disc_loss=args.disc_loss)
    init_state, step_fn, _, _ = make_vae_train_step(vae, loss_cfg, lr=args.lr)
    if args.lpips_ckpt:
        lpips_params = lpips_state_dict(load_torch_state_dict(args.lpips_ckpt))
        print(f"[vae] LPIPS weights loaded from {args.lpips_ckpt}")
    elif args.allow_random_lpips:
        lpips_params = init_params(LPIPS(), seed=1).state_dict()
        print("[vae] WARNING: RANDOM LPIPS features — the perceptual term "
              "is meaningless; pass --lpips-ckpt for real runs")
    else:
        raise SystemExit("pass --lpips-ckpt (or --allow-random-lpips for smoke runs)")

    images = _load_images(args.images, args.image_size, limit=args.max_images)
    print(f"[vae] {len(images)} images @ {args.image_size}px")
    state = init_state(seed=args.seed)

    os.makedirs(args.out, exist_ok=True)
    metrics_path = os.path.join(args.out, "metrics.jsonl")
    timing_path = os.path.join(args.out, "timing.jsonl")
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    with open(metrics_path, "a") as mf, open(timing_path, "a") as tf:
        for i in range(args.steps):
            idx = rng.integers(0, len(images), args.batch_size)
            t_step = time.perf_counter()
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            x = torch.from_numpy(images[idx]).to(dev)
            state, logs = step_fn(state, x, generator=gen, lpips_params=lpips_params)
            if cuda:
                torch.cuda.synchronize(dev)
            tf.write(json.dumps({"step": i, "step_s": time.perf_counter() - t_step,
                                 **device_memory_stats(dev)}) + "\n")
            if i % args.log_every == 0 or i == args.steps - 1:
                row = {k: float(v) for k, v in logs.items()}
                row.update(step=i, wall_s=round(time.perf_counter() - t0, 2))
                mf.write(json.dumps(row) + "\n")
                mf.flush()
                print(f"[vae] step {i}: ae {row['aeloss']:.4f} "
                      f"disc {row['discloss']:.4f} nll {row['nll_loss']:.4f} "
                      f"kl {row['kl_loss']:.2f}", flush=True)

    save_params(os.path.join(args.out, "vae"), {"vae": state.vae.state_dict()})
    save_params(os.path.join(args.out, "disc"), {"disc": state.disc.state_dict()})
    print(f"[vae] saved {args.out}/vae (+disc)")
    return state


if __name__ == "__main__":
    main()
