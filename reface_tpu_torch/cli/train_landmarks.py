"""Distill the batched LandmarkNet from landmark labels (port of
reface_tpu/cli/train_landmarks.py).

The serving path's landmark conditioning runs the batched LandmarkNet
(nn/landmarks.py), distilled offline from an annotator's labels so that the
136-d conditioning matches the reference's per-image dlib call
(ddpm.py:1068-1099).

Label sources:
  * the `.npz` arrays `images` (N,S,S,3 uint8, aligned crops) and `landmarks`
    (N,68,2 pixel coordinates), e.g. data/synthetic.py::make_landmark_faces;
  * `--rert model.rert`: labels computed here by the exact ERT cascade over
    the npz's images (full-image boxes, nn/landmarks.py::
    landmark68_fn_from_rert); the npz's own `landmarks` (if present) stay an
    independent ground truth, and the final report gives the CNN's error
    against both.

A `--val-frac` holdout is never trained on; the last line reports its mean
per-point px error. The loss is L1 in pixels; the optimizer is optax.adamw's
(weight decay 1e-4) under a cosine decay to 0 over --steps
(pipelines/train.py::AdamW); the batches are the JAX driver's default_rng
draws. Every flag of the JAX driver keeps its name and default, except that
`--backend` is `--device {cuda,cpu}` (the card unless the CPU is asked for;
raises without a card), and that --out names the torch file of the trained
state dict, which cli.swap's and cli.train's --landmark-ckpt read.

Usage:
  python -m reface_tpu_torch.cli.train_landmarks --data landmarks.npz \\
      --out lmnet.pt --steps 2000 [--rert model.rert] [--device cpu --tiny]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", required=True, help=".npz with images[+landmarks]")
    ap.add_argument("--out", required=True, help="torch file of the trained state dict")
    ap.add_argument("--rert", default=None,
                    help="native .rert model: labels come from the exact "
                         "ERT over the npz images (distill-from-dlib mode)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--val-frac", type=float, default=0.1,
                    help="holdout fraction for the px-error report")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) or the CPU")
    return ap


def tiny_landmark_config(size: int):
    from reface_tpu_torch.nn.landmarks import LandmarkNetConfig

    return LandmarkNetConfig(widths=(8, 16, 32, 32), input_size=size, dtype=torch.float32)


def make_landmark_step(net, opt):
    """step(imgs (B,3,S,S) in [-1,1], lms (B,136)) -> the L1 loss in pixels
    before the update; one AdamW call."""
    params = opt.params

    def step(imgs, lms):
        loss = torch.mean(torch.abs(net(imgs) - lms))
        opt.step(torch.autograd.grad(loss, params, allow_unused=True))
        return loss.detach()

    return step


def landmark_optimizer(net, lr: float, steps: int):
    """optax.adamw(cosine_decay_schedule(lr, steps)): weight decay 1e-4."""
    from reface_tpu_torch.pipelines.train import AdamW, cosine_decay_schedule

    return AdamW(dict(net.named_parameters()), lr=cosine_decay_schedule(lr, steps),
                 weight_decay=1e-4)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from reface_tpu_torch.cli.common import resolve_device
    from reface_tpu_torch.nn.landmarks import LandmarkNet, LandmarkNetConfig
    from reface_tpu_torch.pipelines.swap import init_params

    dev = resolve_device(args)
    data = np.load(args.data)
    images = data["images"]
    n, s = images.shape[0], images.shape[1]
    gt = data["landmarks"].astype(np.float32) if "landmarks" in data else None

    if args.rert:
        from reface_tpu_torch.nn.landmarks import landmark68_fn_from_rert

        ert_fn = landmark68_fn_from_rert(args.rert)
        labels = np.concatenate([
            ert_fn(images[i:i + 256].astype(np.float32) / 255.0)
            for i in range(0, n, 256)
        ]).astype(np.float32)
        print(f"[lm] labels: native ERT over {n} crops ({args.rert})")
    elif gt is not None:
        labels = gt
        print("[lm] labels: npz landmarks")
    else:
        raise SystemExit("--data has no `landmarks` array; pass --rert")
    labels_flat = labels.reshape(n, -1)

    n_val = max(1, int(n * args.val_frac)) if args.val_frac > 0 else 0
    n_tr = n - n_val
    print(f"[lm] {n_tr} train / {n_val} val @ {s}px")

    cfg = tiny_landmark_config(s) if args.tiny else LandmarkNetConfig(input_size=s)
    net = LandmarkNet(cfg, device=dev, param_dtype=torch.float32)
    init_params(net, seed=args.seed)
    step = make_landmark_step(net, landmark_optimizer(net, args.lr, args.steps))

    def to_input(u8):
        x = torch.from_numpy(u8).to(dev).float() / 127.5 - 1.0
        return x.permute(0, 3, 1, 2).contiguous()

    @torch.no_grad()
    def px_error(idx, ref):
        """Mean per-point euclidean px error of the CNN against `ref`."""
        errs = []
        for i in range(0, len(idx), 64):
            ii = idx[i:i + 64]
            pred = net(to_input(images[ii])).float().cpu().numpy().reshape(-1, 68, 2)
            errs.append(np.sqrt(((pred - ref[ii].reshape(-1, 68, 2)) ** 2).sum(-1)).mean(-1))
        return float(np.concatenate(errs).mean())

    rng = np.random.default_rng(args.seed)
    for i in range(args.steps):
        idx = rng.integers(0, n_tr, args.batch_size)
        loss = step(to_input(images[idx]), torch.from_numpy(labels_flat[idx]).to(dev))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"[lm] step {i}: L1 {float(loss):.3f} px", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()}, args.out)
    print(f"[lm] saved {args.out}")

    if n_val:
        val_idx = np.arange(n_tr, n)
        err = px_error(val_idx, labels)
        src = "ERT" if args.rert else "labels"
        print(f"[lm] val mean px error vs {src} @{s}px: {err:.2f} (n={n_val})")
        if args.rert and gt is not None:
            err_gt = px_error(val_idx, gt)
            ert_gt = float(np.sqrt(((labels[val_idx] - gt[val_idx]) ** 2).sum(-1)).mean())
            print(f"[lm] val mean px error vs GT @{s}px: {err_gt:.2f} "
                  f"(teacher ERT vs GT: {ert_gt:.2f})")
    return net


if __name__ == "__main__":
    main()
