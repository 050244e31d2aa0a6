"""Training driver: the train loop with checkpointing and logging (port of
reface_tpu/cli/train.py).

Functional parity target: /root/reference/main.py + train.sh: layered YAML
with dotlist overrides, the LR scaled by the batch, periodic image and
sample logging, validation loss with top-k and last checkpoints, a crash
checkpoint, an on-demand checkpoint on SIGUSR1, and resume. The step is
pipelines/train.py's, the batches are moved to the card here, the
checkpoints are ckpt/io.py's directories.

Several processes, one card each, train data-parallel (parallel/mesh.py):
launched by torchrun, or each given `--coordinator host:port
--num-processes N --process-id I`. `--batch-size` is per device, the world
batch `batch_size x world` and the LR `base_lr x world batch`; each process
loads its slice of every world batch, the gradients are averaged over the
ranks, and rank 0 alone writes metrics.jsonl, timing.jsonl, the images,
the samples and the checkpoints. The validation loss is the world batch's
mean on every rank, so every rank takes the same top-k decision.

Every flag of the JAX driver keeps its name and default, except that
`--backend` is `--device {cuda,cpu}` (the card unless the CPU is asked for;
raises without a card; with several processes the CPU ranks use gloo, the
cards NCCL).

Besides metrics.jsonl (the JAX driver's keys), the driver appends to
timing.jsonl, per step: its wall seconds (the card synchronised at its end),
the seconds it waited on the loader, the learning rate it ran with and the
card's peak memory; per checkpoint: its bytes and save seconds; and the
resume's load seconds.

Usage:
  python -m reface_tpu_torch.cli.train --dataset-dir ... --logdir logs/run1 \\
      [--device cpu --tiny --image-size 64 --steps 10]   # smoke
  torchrun --nproc_per_node 8 -m reface_tpu_torch.cli.train --dataset-dir ... \\
      --logdir logs/run1                                  # 8 cards
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--dataset", default="celeba", choices=["celeba", "ffhq"])
    ap.add_argument("--logdir", required=True)
    ap.add_argument("--batch-size", type=int, default=1, help="per device")
    ap.add_argument("--base-lr", type=float, default=1e-5)
    ap.add_argument("--warmup-steps", type=int, default=10000)
    ap.add_argument("--steps", type=int, default=0, help="0 = epochs mode")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--train-count", type=int, default=28000)
    ap.add_argument("--black-outer-mask", dest="gray_outer_mask", action="store_false",
                    help="use the __getitem_black__ item recipe (gray_outer_mask: "
                         "False in the reference config): no decow TPS warp of the "
                         "inpaint mask (celeba only)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--full-losses", action="store_true",
                    help="enable DDIM-recon ID/LPIPS losses")
    ap.add_argument("--split-grad", type=int, nargs="?", const=1, default=0,
                    help="the full loss's backward in pieces, with the same "
                         "gradients and a lower peak memory: 1 = the recon "
                         "portion's backward, then the eps portion's; 2 = the "
                         "recon portion cut once more at the collected latents")
    ap.add_argument("--mu-dtype", default=None, choices=[None, "bfloat16"],
                    help="AdamW first-moment dtype")
    ap.add_argument("--split-acc-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="split-grad accumulator dtype; bfloat16 rounds the "
                         "recon gradient's contribution to bf16 before the sum")
    ap.add_argument("--ckpt-every", type=int, default=10000)
    ap.add_argument("--final-ckpt", default=True, action=argparse.BooleanOptionalAction,
                    help="save the full train state as 'last' at the end "
                         "(default; --no-final-ckpt for measurement runs)")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--image-log-every", type=int, default=500)
    ap.add_argument("--resume", default=None,
                    help="a checkpoint directory (full train state), or a "
                         "params file: the port's, or a REFace last.ckpt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-every", type=int, default=0, help="0 = off")
    ap.add_argument("--val-count", type=int, default=64)
    ap.add_argument("--keep-top-k", type=int, default=3,
                    help="retain k best val-loss checkpoints (ref keeps 30)")
    ap.add_argument("--sample-log-every", type=int, default=0,
                    help="generate swap samples every N steps (0 = off)")
    ap.add_argument("--ema-decay", type=float, default=0.0,
                    help="0 = EMA off (shipped config)")
    ap.add_argument("--ema-dtype", default=None, choices=[None, "bfloat16", "float32"],
                    help="EMA shadow dtype (default: the parameters', fp32)")
    ap.add_argument("--lpips-ckpt", default=None,
                    help="pretrained LPIPS(alex) torch checkpoint (full module "
                         "dump, or torchvision alexnet merged with the official "
                         "lin weights); without it the LPIPS term runs on RANDOM "
                         "features")
    ap.add_argument("--landmark-ckpt", default=None,
                    help="torch file of a LandmarkNet state dict: batched landmark "
                         "conditioning of the GT batch (ddpm.py:1206 get_landmarks)")
    ap.add_argument("--landmark-rert", default=None,
                    help="native ERT model (.rert): exact dlib-parity host "
                         "landmarks for the GT batch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) or the CPU")
    ap.add_argument("--coordinator", default=None,
                    help="multi-process: the coordinator's host:port (rank 0's), "
                         "with --num-processes and --process-id; torchrun's "
                         "environment stands in for all three")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--config", nargs="*", default=[],
                    help="layered YAML config(s) with swap:/train:/recon: nodes "
                         "(main.py:504-506 parity)")
    ap.add_argument("--overrides", nargs="*", default=[],
                    help="dotlist overrides, e.g. train.learning_rate=2e-5 "
                         "swap.ddim_steps=30")
    return ap


def _file_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from reface_tpu_torch.ckpt import io as ckpt_io
    from reface_tpu_torch.cli.common import apply_config_node, resolve_device, save_grid_pm1
    from reface_tpu_torch.core.profiling import device_memory_stats
    from reface_tpu_torch.data import (
        CelebAHQConfig,
        CelebAHQDataset,
        FFHQConfig,
        FFHQDataset,
        PrefetchLoader,
    )
    from reface_tpu_torch.diffusion.losses import ReconLossConfig
    from reface_tpu_torch.parallel import create_mesh, init_distributed, shard_batch, shard_params
    from reface_tpu_torch.parallel.mesh import all_reduce
    from reface_tpu_torch.pipelines.swap import FaceSwapper, SwapConfig, tiny_swap_config
    from reface_tpu_torch.pipelines.train import (
        TrainConfig,
        TrainState,
        make_optimizer,
        make_train_step,
        named_params,
        params_with_ema,
    )

    dev = resolve_device(args)
    proc_id, proc_count = init_distributed(
        args.coordinator, args.num_processes, args.process_id,
        local_device="cpu" if dev.type == "cpu" else None)
    is_main = proc_id == 0
    cuda = dev.type == "cuda"
    if cuda:  # the card init_distributed chose for this rank
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = create_mesh(device=dev)
    if proc_count > 1:
        print(f"[train] process {proc_id}/{proc_count} on {dev}")
    world_batch = args.batch_size * mesh.size
    # the reference's LR scaling rule: lr = accum x nodes x ngpu x bs x base_lr
    lr = args.base_lr * world_batch

    swap_cfg = (tiny_swap_config(image_size=args.image_size) if args.tiny
                else SwapConfig(image_size=args.image_size))
    train_cfg = TrainConfig(
        learning_rate=lr, warmup_steps=args.warmup_steps,
        ema_decay=args.ema_decay or None, ema_dtype=args.ema_dtype,
        split_grad=args.split_grad, split_acc_dtype=args.split_acc_dtype,
        mu_dtype=args.mu_dtype)
    recon = ReconLossConfig() if args.full_losses else None
    if args.config or args.overrides:
        from reface_tpu_torch.core.config import load_config

        node = load_config(args.config, args.overrides)
        if "swap" in node:
            swap_cfg = apply_config_node(swap_cfg, node["swap"])
        if "train" in node:
            train_cfg = apply_config_node(train_cfg, node["train"])
        if "recon" in node:
            recon = apply_config_node(recon or ReconLossConfig(), node["recon"])

    step_fn, loss_fn, init_state = make_train_step(swap_cfg, train_cfg, recon=recon,
                                                   device=dev, mesh=mesh)
    # the towers, seeded (LPIPS and the landmark aux head, built from the
    # UNet's feature shapes, where the recon loss asks for them)
    state = init_state(seed=args.seed)
    modules = state.modules
    if modules.lpips is not None:
        if args.lpips_ckpt:
            # pretrained AlexNet + lin calibration (ddpm.py:634,1779-1797)
            from reface_tpu_torch.ckpt.from_torch import load_torch_state_dict, lpips_state_dict

            modules.lpips.load_state_dict(lpips_state_dict(load_torch_state_dict(args.lpips_ckpt)))
            print(f"[train] LPIPS weights loaded from {args.lpips_ckpt}")
        else:
            print("[train] WARNING: no --lpips-ckpt; the lpips_loss term "
                  "uses RANDOM AlexNet features, not a perceptual loss")

    timing_path = os.path.join(args.logdir, "timing.jsonl")
    if is_main:  # rank 0 alone writes (main.py's rank-zero callbacks)
        os.makedirs(os.path.join(args.logdir, "checkpoints"), exist_ok=True)
        os.makedirs(os.path.join(args.logdir, "images"), exist_ok=True)

    def log_timing(rec: dict) -> None:
        if is_main:
            with open(timing_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    resume_step = 0
    if args.resume:
        # FULL resume (params + optimizer state + step + EMA, the
        # resume_from_checkpoint role); params files (the port's, or a
        # REFace last.ckpt) still bootstrap
        t_load = time.perf_counter()
        try:
            ckpt_io.load_train_state(args.resume, state)
            resume_step = state.step
            print(f"[train] resumed FULL train state at step {resume_step} "
                  f"from {args.resume}")
        except Exception as e:
            # params-only, loudly: the optimizer state, EMA and step counter
            # are NOT restored. A structure mismatch (a checkpoint saved with
            # another --ema-decay) lands here too; if params-only also fails,
            # the original error is raised.
            print(f"[train] WARNING: full-state resume failed "
                  f"({type(e).__name__}: {e}); trying params-only "
                  f"(optimizer/EMA/step will restart)")
            try:
                towers = modules.towers()
                for name, sd in _resume_params(args.resume, swap_cfg).items():
                    if name in towers:
                        towers[name].load_state_dict(sd)
            except Exception:
                raise e
            # a new optimizer, step and EMA over these weights (the old
            # moments dropped first)
            state.opt = state.ema = None
            state = TrainState.create(modules, make_optimizer(train_cfg, named_params(modules)),
                                      ema_decay=train_cfg.ema_decay,
                                      ema_dtype=train_cfg.ema_dtype)
            print(f"[train] resumed params only from {args.resume}")
        # every rank loaded the files; rank 0's values are the ones kept
        shard_params(modules, mesh)
        if cuda:
            torch.cuda.synchronize(dev)
        log_timing({"resume_load_s": time.perf_counter() - t_load, "step": state.step,
                    **device_memory_stats(dev)})

    def dataset(state_name: str, count: int | None = None):
        kw = dict(dataset_dir=args.dataset_dir, state=state_name,
                  image_size=args.image_size, train_count=args.train_count,
                  data_seed=args.seed)
        if count is not None:
            kw["eval_count"] = count
        if args.dataset == "celeba":
            # the recipe flag only decides the train items' TPS warp
            return CelebAHQDataset(CelebAHQConfig(**kw, gray_outer_mask=args.gray_outer_mask))
        return FFHQDataset(FFHQConfig(**kw))

    # landmark conditioning of the GT batch (the 0.05-weight stream; the
    # reference computes dlib landmarks inside get_input, ddpm.py:1206)
    landmark_fn = None
    if args.landmark_ckpt:
        from reface_tpu_torch.ckpt.from_torch import load_torch_state_dict
        from reface_tpu_torch.nn.landmarks import LandmarkNet, LandmarkNetConfig, landmark_fn_from_net

        net = LandmarkNet(LandmarkNetConfig(), device=dev)
        net.load_state_dict(load_torch_state_dict(args.landmark_ckpt))
        landmark_fn = landmark_fn_from_net(net.eval(), args.image_size)
    elif args.landmark_rert:
        from reface_tpu_torch.nn.landmarks import landmark_fn_from_rert

        landmark_fn = landmark_fn_from_rert(args.landmark_rert, args.image_size)

    def to_batch(raw: dict) -> dict:
        """The loader's numpy batch -> the step's batch on the card."""
        d = shard_batch({k: raw[name] for k, name in (
            ("target_image", "GT"), ("inpaint_image", "inpaint_image"),
            ("inpaint_mask", "inpaint_mask"), ("ref_clip224", "ref_imgs"))}, mesh)
        if landmark_fn is not None:
            # a copy: the net's output is an inference-mode tensor
            lm = torch.as_tensor(landmark_fn(d["target_image"]))
            d["landmarks"] = lm.to(dev, torch.float32).clone()
        return d

    shards = dict(process_index=proc_id, process_count=proc_count)
    loader = PrefetchLoader(dataset("train"), batch_size=world_batch, shuffle=True,
                            seed=args.seed, **shards)
    val_loader = None
    if args.val_every:
        val_loader = PrefetchLoader(dataset("validation", args.val_count),
                                    batch_size=world_batch, shuffle=False, **shards)

    metrics_path = os.path.join(args.logdir, "metrics.jsonl")
    want_ckpt = {"now": False}
    try:
        signal.signal(signal.SIGUSR1, lambda *_: want_ckpt.update(now=True))
    except (ValueError, OSError):
        pass

    # the step and path of the last save: a save at the same step (the
    # state has not moved) links that save's files
    saved = {"step": None, "path": None}

    def checkpoint(tag):
        if not is_main:
            return
        path = os.path.join(args.logdir, "checkpoints", tag)
        t = time.perf_counter()
        if saved["step"] != state.step or not link_checkpoint(saved["path"], path):
            # full state (params + opt + step + EMA) so --resume continues
            # exactly; params-only consumers read the params file
            ckpt_io.save_train_state(path, state)
        saved.update(step=state.step, path=path)
        log_timing({"ckpt": tag, "step": state.step, "bytes": _file_bytes(path),
                    "save_s": time.perf_counter() - t})
        print(f"[train] checkpoint -> {path}")

    top_k: list[tuple[float, str]] = []  # (val_loss, tag), best first

    def maybe_top_k(vloss, step_no):
        """ModelCheckpoint parity: keep the k best checkpoints by val loss."""
        if len(top_k) < args.keep_top_k or vloss < top_k[-1][0]:
            tag = f"best_{step_no:08d}_loss{vloss:.4f}"
            checkpoint(tag)
            top_k.append((vloss, tag))
            top_k.sort(key=lambda t: t[0])
            while len(top_k) > args.keep_top_k:
                _, old = top_k.pop()
                if is_main:
                    shutil.rmtree(os.path.join(args.logdir, "checkpoints", old),
                                  ignore_errors=True)

    def val_loss() -> float:
        """The mean over the validation batches of each world batch's loss
        (the ranks' slices averaged over the data group)."""
        vlosses = []
        with torch.no_grad():
            for vb in val_loader:
                gen = torch.Generator(device=dev).manual_seed(99)
                loss = loss_fn(modules, to_batch(vb), generator=gen)[0]
                vlosses.append(float(all_reduce(loss.float().clone(), mesh.data_group)
                                     / mesh.n_data))
        return float(np.mean(vlosses)) if vlosses else float("nan")

    def sample(raw_batch, step_no):
        """ImageLogger parity: swap samples with the current (EMA when
        enabled) weights, 8 DDIM steps."""
        sample_cfg = dataclasses.replace(swap_cfg, ddim_steps=8)
        sw = FaceSwapper(sample_cfg, params_with_ema(state.params(), state), device=dev)
        n = min(2, raw_batch["GT"].shape[0])
        out = sw.swap(target_image=raw_batch["GT"][:n],
                      inpaint_image=raw_batch["inpaint_image"][:n],
                      inpaint_mask=raw_batch["inpaint_mask"][:n],
                      ref_clip224=raw_batch["ref_imgs"][:n],
                      generator=torch.Generator(device=dev).manual_seed(step_no))
        out = out.float().cpu().numpy()
        save_grid_pm1(os.path.join(args.logdir, "images", f"samples_{step_no:08d}.png"),
                      [raw_batch["GT"][i] for i in range(n)] + [out[i] for i in range(n)])

    generator = torch.Generator(device=dev).manual_seed(args.seed + 1)
    step = resume_step
    t0 = time.perf_counter()
    try:
        for epoch in range(args.epochs):
            batches = iter(loader)
            while True:
                t_wait = time.perf_counter()
                raw_batch = next(batches, None)
                if raw_batch is None:
                    break
                t_step = time.perf_counter()
                if cuda:
                    torch.cuda.reset_peak_memory_stats(dev)
                state, metrics = step_fn(state, to_batch(raw_batch), generator=generator)
                lr_used = state.opt.lr(state.opt.count - 1)
                step += 1
                if cuda:
                    torch.cuda.synchronize(dev)
                t_end = time.perf_counter()
                log_timing({"step": step, "step_s": t_end - t_wait,
                            "loader_wait_s": t_step - t_wait, "lr": lr_used,
                            **device_memory_stats(dev)})
                if step % args.log_every == 0 and is_main:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=step, epoch=epoch, sps=step / (time.perf_counter() - t0))
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps(m) + "\n")
                    print(f"[train] {m}")
                if step % args.image_log_every == 0 and is_main:
                    save_grid_pm1(os.path.join(args.logdir, "images", f"inputs_{step:08d}.png"),
                                  [raw_batch["GT"][0], raw_batch["inpaint_image"][0]])
                if args.sample_log_every and step % args.sample_log_every == 0 and is_main:
                    sample(raw_batch, step)
                if args.val_every and step % args.val_every == 0:
                    vloss = val_loss()
                    if is_main:
                        with open(metrics_path, "a") as f:
                            f.write(json.dumps({"step": step, "val_loss": vloss}) + "\n")
                    maybe_top_k(vloss, step)
                if want_ckpt["now"]:
                    want_ckpt["now"] = False
                    checkpoint(f"sig_{step:08d}")
                if step % args.ckpt_every == 0:
                    checkpoint(f"step_{step:08d}")
                if args.steps and step >= args.steps:
                    raise StopIteration
    except StopIteration:
        pass
    except Exception:
        # melk() parity: save before re-raising; best-effort, so that a
        # failed crash save cannot mask the real error
        try:
            checkpoint("crash_last")
        except Exception as ce:
            print(f"[train] WARNING: crash checkpoint failed ({type(ce).__name__}: {ce})")
        raise
    finally:
        loader.close()
    if args.final_ckpt:
        checkpoint("last")
    else:
        print("[train] --no-final-ckpt: skipping the final 'last' save")
    if step == resume_step:
        # a silent no-op run is almost always a config error: a world batch
        # larger than the dataset slice (the loader drops the ragged batch)
        print(f"[train] WARNING: no steps ran (still at step {step}) — check the "
              f"world batch ({args.batch_size} x {mesh.size} processes) against the "
              f"dataset slice")
    print(f"[train] done at step {step}")
    return state


def link_checkpoint(src: str | None, dst: str) -> bool:
    """dst made of hard links to the files of the checkpoint directory src.
    False, with nothing left at dst, where src is gone or the filesystem
    refuses the links: the caller then saves in full."""
    from reface_tpu_torch.ckpt import io as ckpt_io

    files = ckpt_io.checkpoint_files(src) if src and os.path.isdir(src) else []
    if not files:
        return False
    try:
        os.makedirs(dst, exist_ok=True)
        for f in files:
            target = os.path.join(dst, os.path.basename(f))
            if os.path.exists(target):
                os.remove(target)
            os.link(f, target)
    except OSError:
        shutil.rmtree(dst, ignore_errors=True)
        return False
    return True


def _resume_params(path: str, swap_cfg) -> dict:
    """tower name -> state dict for the params-only resume: a checkpoint
    directory's params file, the port's params file, or a REFace last.ckpt."""
    from reface_tpu_torch.ckpt import io as ckpt_io
    from reface_tpu_torch.ckpt.from_torch import (
        is_swap_params,
        load_torch_state_dict,
        reface_state_dicts,
    )

    if os.path.isdir(path):
        return ckpt_io.load_params(path)
    sd = load_torch_state_dict(path)
    return sd if is_swap_params(sd) else reface_state_dicts(swap_cfg, sd)


if __name__ == "__main__":
    main()
