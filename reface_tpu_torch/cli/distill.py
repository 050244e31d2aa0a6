"""Step-count distillation driver: teacher DDIM-50 + CFG -> student DDIM-K
(port of reface_tpu/cli/distill.py).

Progressive distillation with guidance folding (diffusion/distill.py). Only
the student UNet is trained; a separate teacher UNet is frozen (in bf16
under --teacher-dtype bfloat16), and the VAE and the conditioner are frozen
and shared. Round 0 folds CFG into the student; each later round's teacher
is a copy (or a cast) of the previous student. Adam runs at a constant --lr
(pipelines/train.py::AdamW, --mu-dtype honoured) and starts afresh each
round. The towers are resolved for training as cli/train.py's are: flash
attention (the residual K2 forward, K4/K5 in the student's backward) and
UNet remat.

Every flag of the JAX driver keeps its name and default, except that
`--backend` is `--device {cuda,cpu}` (the card unless the CPU is asked for;
raises without a card); `--train-count` sizes the dataset's train split
(the JAX driver takes the dataset's default, 28000). --teacher-ckpt reads
what cli.swap's --ckpt reads (a REFace last.ckpt or the port's params file).

The output directory holds params.pt (ckpt/io.py's layout: the student UNet
with the shared towers, which `cli.swap --ckpt <out>/params.pt` loads),
manifest.json (the JAX driver's keys) and timing.jsonl (per step: round,
seconds with the card synchronised, loss and peak memory). Serve with
  --ckpt <out>/params.pt --ddim-steps <K> --scale 1.0   (fold-cfg default)

Usage:
  python -m reface_tpu_torch.cli.distill --out distilled [--dataset-dir D]
      [--teacher-ckpt last.ckpt] [--device cpu --tiny --steps-per-round 10]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--teacher-ckpt", default=None,
                    help="REFace last.ckpt or the port's params file; default "
                         "random init (smoke)")
    ap.add_argument("--dataset-dir", default=None,
                    help="CelebA-HQ layout for training batches; default "
                         "synthetic noise batches (smoke)")
    ap.add_argument("--dataset", default="celeba", choices=["celeba", "ffhq"])
    ap.add_argument("--train-count", type=int, default=28000,
                    help="items of the dataset's train split")
    ap.add_argument("--teacher-steps", type=int, default=50)
    ap.add_argument("--target-steps", type=int, default=10)
    ap.add_argument("--cfg-scale", type=float, default=3.0)
    ap.add_argument("--no-fold-cfg", action="store_true",
                    help="keep CFG in the student (2x serving cost)")
    ap.add_argument("--steps-per-round", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--max-rounds", type=int, default=0,
                    help="run only the first N plan rounds (0 = all); round 0 is "
                         "the guidance-folding round and the memory-heaviest")
    ap.add_argument("--teacher-dtype", default=None, choices=[None, "bfloat16"],
                    help="store the frozen teacher in bf16 (forward only)")
    ap.add_argument("--mu-dtype", default=None, choices=[None, "bfloat16"],
                    help="Adam first-moment dtype (the memory lever of cli/train.py)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) or the CPU")
    return ap


def _batches(args):
    """The training batches, NHWC numpy in the JAX layout: the dataset's, or
    the JAX driver's synthetic ones from the same default_rng stream."""
    if args.dataset_dir:
        from reface_tpu_torch.data import (
            CelebAHQConfig,
            CelebAHQDataset,
            FFHQConfig,
            FFHQDataset,
            PrefetchLoader,
        )

        ds_cls, cfg_cls = ((CelebAHQDataset, CelebAHQConfig) if args.dataset == "celeba"
                           else (FFHQDataset, FFHQConfig))
        ds = ds_cls(cfg_cls(dataset_dir=args.dataset_dir, state="train",
                            image_size=args.image_size, train_count=args.train_count,
                            data_seed=args.seed))
        loader = PrefetchLoader(ds, batch_size=args.batch_size, shuffle=True, seed=args.seed)
        try:
            while True:
                for raw in loader:
                    yield {"target_image": raw["GT"], "inpaint_image": raw["inpaint_image"],
                           "inpaint_mask": raw["inpaint_mask"], "ref_clip224": raw["ref_imgs"]}
        finally:
            loader.close()
    rng = np.random.default_rng(args.seed)
    s, b = args.image_size, args.batch_size
    while True:
        t = rng.uniform(-1, 1, (b, s, s, 3))
        m = np.ones((b, s, s, 1), np.float32)
        m[:, s // 4: -s // 4, s // 4: -s // 4] = 0.0
        yield {"target_image": t.astype(np.float32),
               "inpaint_image": (t * m).astype(np.float32),
               "inpaint_mask": m,
               "ref_clip224": rng.normal(size=(b, 224, 224, 3)).astype(np.float32)}


def distill_inputs(modules, batch: dict):
    """(z0, rest, context, uncond_context) of a batch (NHWC, the JAX layout)
    from the frozen towers, without gradients: the target's and the masked
    target's posterior modes, scaled, the mask resized to the latent, and
    the fused conditioning with its null token."""
    from reface_tpu_torch.ops.resize import resize_bilinear_no_aa

    dev = modules.device
    nchw = lambda a: torch.as_tensor(a, device=dev).float().permute(0, 3, 1, 2).contiguous()
    target = nchw(batch["target_image"])
    hw = target.shape[-1] // (modules.config.image_size // modules.config.latent_size)
    with torch.no_grad():  # the frozen towers: JAX's stop_gradient
        c, uc = modules.build_context(nchw(batch["ref_clip224"]), target, None)
        z0 = modules.encode_latent(target)
        z_inp = modules.encode_latent(nchw(batch["inpaint_image"]))
        mask_l = resize_bilinear_no_aa(nchw(batch["inpaint_mask"]), hw, hw)
    return z0, torch.cat([z_inp, mask_l], dim=1), c, uc


def main(argv=None):
    args = build_parser().parse_args(argv)

    from reface_tpu_torch.ckpt.io import save_params
    from reface_tpu_torch.cli.common import read_swap_params, resolve_device
    from reface_tpu_torch.core.profiling import device_memory_stats
    from reface_tpu_torch.diffusion.distill import (
        DistillConfig,
        distill_schedule_plan,
        make_distill_draws,
        make_distill_loss,
    )
    from reface_tpu_torch.nn.unet import UNetModel
    from reface_tpu_torch.pipelines.swap import (
        SwapConfig,
        SwapModules,
        init_params,
        tiny_swap_config,
    )
    from reface_tpu_torch.pipelines.train import AdamW, TrainConfig, resolve_train_swap_cfg

    dev = resolve_device(args)
    cuda = dev.type == "cuda"
    swap_cfg = (tiny_swap_config(image_size=args.image_size) if args.tiny
                else SwapConfig(image_size=args.image_size))
    # the student is differentiated: flash attention (K1 has no backward) and
    # UNet block remat, cli/train.py's resolution
    swap_cfg = resolve_train_swap_cfg(swap_cfg, TrainConfig(), None)
    # fp32 weights where they are trained (the student UNet), as flax keeps them
    modules = SwapModules(swap_cfg, dev, param_dtype=torch.float32)
    if args.teacher_ckpt:
        modules.load_params(read_swap_params(swap_cfg, args.teacher_ckpt,
                                             flag="--teacher-ckpt"))
    else:
        print("[distill] WARNING: random teacher (no --teacher-ckpt) — "
              "infrastructure smoke only")
        for i, m in enumerate(modules.towers().values()):
            init_params(m, seed=args.seed + i)
    student = modules.unet
    teacher_dtype = torch.bfloat16 if args.teacher_dtype == "bfloat16" else torch.float32

    def frozen_copy(unet):
        """The next teacher: a separate frozen UNet with the given weights,
        cast to --teacher-dtype."""
        t = UNetModel(swap_cfg.unet, device=dev, param_dtype=teacher_dtype)
        t.load_state_dict(unet.state_dict())
        return t.eval().requires_grad_(False)

    teacher = frozen_copy(student)
    student.requires_grad_(True)
    factor = swap_cfg.image_size // swap_cfg.latent_size

    def loss_of(loss_fn, batch, draws):
        return loss_fn(student, teacher, *distill_inputs(modules, batch), draws)

    plan = distill_schedule_plan(args.teacher_steps, args.target_steps)
    if args.max_rounds:
        plan = plan[: args.max_rounds]
    print(f"[distill] round plan: {args.teacher_steps} -> {plan}")
    os.makedirs(args.out, exist_ok=True)
    timing_path = os.path.join(args.out, "timing.jsonl")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    batches = _batches(args)
    history = []
    cur_teacher_steps = args.teacher_steps
    for round_i, student_steps in enumerate(plan):
        fold = not args.no_fold_cfg
        # with folding the round-0 student absorbs the guidance; later
        # teachers (the previous students) are already unguided
        scale = args.cfg_scale if (round_i == 0 or not fold) else 1.0
        dcfg = DistillConfig(teacher_steps=cur_teacher_steps, student_steps=student_steps,
                             cfg_scale=scale, fold_cfg=fold)
        loss_fn, _, _ = make_distill_loss(dcfg, device=dev)
        opt = AdamW(dict(student.named_parameters()), lr=args.lr, mu_dtype=args.mu_dtype)
        print(f"[distill] round {round_i}: {cur_teacher_steps} -> {student_steps} steps, "
              f"cfg={scale}, fold={dcfg.fold_cfg}")
        t0 = time.perf_counter()
        for it in range(args.steps_per_round):
            batch = next(batches)
            t_step = time.perf_counter()
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            draws = make_distill_draws(args.batch_size, args.image_size // factor, dcfg,
                                       dev, gen)
            loss, m = loss_of(loss_fn, batch, draws)
            opt.step(torch.autograd.grad(loss, opt.params, allow_unused=True))
            loss_v = float(m["distill_loss"])  # syncs the step
            t_end = time.perf_counter()
            history.append({"round": round_i, "step": it + 1, "loss": loss_v,
                            "eps_mse": float(m["eps_mse"])})
            with open(timing_path, "a") as f:
                f.write(json.dumps({"round": round_i, "step": it + 1,
                                    "step_s": t_end - t_step, "loss": loss_v,
                                    **device_memory_stats(dev)}) + "\n")
            if (it + 1) % args.log_every == 0 or it == 0:
                rate = (1 if it == 0 else it) / (t_end - t0)
                print(f"[distill] r{round_i} it{it + 1} loss={loss_v:.5f} "
                      f"eps_mse={float(m['eps_mse']):.5f} ({rate:.3f} it/s"
                      f"{' first step' if it == 0 else ' steady'})", flush=True)
            if it == 0:
                # restart the clock after the first step, so that the rate
                # printed is the steady step rate
                t0 = time.perf_counter()
        del opt
        # the next round distils this student from a separate copy of it
        teacher = None
        teacher = frozen_copy(student)
        cur_teacher_steps = student_steps

    out_params = {name: m.state_dict() for name, m in modules.towers().items()}
    save_params(args.out, out_params)
    manifest = {
        "ddim_steps": cur_teacher_steps,
        "cfg_scale": 1.0 if not args.no_fold_cfg else args.cfg_scale,
        "teacher_steps": args.teacher_steps,
        "teacher_cfg_scale": args.cfg_scale,
        "rounds": plan,
        "mode": "distilled",
    }
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    params_file = os.path.join(args.out, "params.pt")
    print(f"[distill] saved student -> {args.out} (serve: --ckpt {params_file} "
          f"--ddim-steps {manifest['ddim_steps']} --scale {manifest['cfg_scale']})")
    return {"modules": modules, "teacher": teacher, "history": history,
            "manifest": manifest}


if __name__ == "__main__":
    main()
