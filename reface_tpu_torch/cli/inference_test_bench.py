"""Batched test-bench swap driver (port of
reface_tpu/cli/inference_test_bench.py).

The reference's scripts/inference_test_bench.py and inference_test_bench.sh:
the frozen pair lists (data/test_bench.py), DDIM-50 with CFG 3, --n-samples
pairs a batch through FaceSwapper.swap, each result written as
results/{source}_{target}.png, with --save-aux the GT/, inpaint/, mask/ and
grid/ dumps. The host loader decodes the next batch while the card runs
this one. The ragged last batch is padded to --n-samples with its last item,
as the JAX driver pads it to its compiled shape, and the padded rows are
never written. One torch.Generator on the swapper's device, seeded from
--seed, draws every batch's noise in turn (the JAX package splits keys
instead: the two draw different numbers).

Usage (on the card; --device cpu --tiny for a smoke run on the CPU):
  python -m reface_tpu_torch.cli.inference_test_bench --ckpt last.ckpt \\
      --dataset-dir dataset/FaceData/CelebAMask-HQ --dataset celeba \\
      --outdir results/celeba --n-samples 10
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from reface_tpu_torch.cli.common import add_model_args, build_swapper, save_grid_pm1, save_image_pm1


def main(argv=None) -> list:
    """Run the driver; returns (the seconds of each batch, from the loader's
    hand-over to its last file written; the seconds of the whole loop, from
    the first batch asked of the loader to the last file written)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(ap)
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--dataset", default="celeba", choices=["celeba", "ffhq", "ff"])
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--n-samples", type=int, default=10, help="pairs a batch")
    ap.add_argument("--num-pairs", type=int, default=1000)
    ap.add_argument("--save-aux", action="store_true",
                    help="also dump grid/mask/GT/inpaint")
    ap.add_argument("--head-swap", action="store_true",
                    help="universal head swap: extend masks with hair/hat")
    ap.add_argument("--landmark-ckpt", default=None,
                    help="torch file of a LandmarkNet state dict: landmark "
                         "conditioning from the target, on the card")
    ap.add_argument("--landmark-rert", default=None,
                    help="native .rert ERT model: exact dlib-parity landmark "
                         "conditioning computed on the host per batch "
                         "(get_landmarks, ddpm.py:1068-1099)")
    ap.add_argument("--prior-dir", default=None,
                    help="dir of {target_id}.png priors: q-sample the DDIM "
                         "start from the prior latent (load_prior, "
                         "inference_test_bench.py:414-436)")
    ap.add_argument("--start-from-target", action="store_true",
                    help="q-sample the DDIM start from the TARGET latent "
                         "(--Start_from_target with use_prior and no prior "
                         "dir: prior == GT, test_bench_dataset.py:363)")
    ap.add_argument("--safety-ckpt", default=None,
                    help="StableDiffusionSafetyChecker state dict: blur "
                         "flagged outputs (inference_test_bench.py:48-51)")
    args = ap.parse_args(argv)

    from reface_tpu_torch.cli.common import build_safety_checker
    from reface_tpu_torch.data import PrefetchLoader, TestBenchConfig, TestBenchDataset

    swapper = build_swapper(args)
    size, dev = swapper.config.image_size, swapper.device

    landmark_fn = None
    if args.landmark_ckpt:
        from reface_tpu_torch.ckpt.from_torch import load_torch_state_dict
        from reface_tpu_torch.nn.landmarks import LandmarkNet, LandmarkNetConfig, landmark_fn_from_net

        net = LandmarkNet(LandmarkNetConfig(), device=dev)
        net.load_state_dict(load_torch_state_dict(args.landmark_ckpt))
        landmark_fn = landmark_fn_from_net(net.eval(), size)
    elif args.landmark_rert:
        from reface_tpu_torch.nn.landmarks import landmark_fn_from_rert

        landmark_fn = landmark_fn_from_rert(args.landmark_rert, size)
    safety = build_safety_checker(args.safety_ckpt, device=dev)

    bench_kw = dict(dataset_dir=args.dataset_dir, dataset=args.dataset, image_size=size,
                    num_pairs=args.num_pairs, prior_dir=args.prior_dir)
    if args.head_swap:
        from reface_tpu_torch.preprocess.masks import HEAD_SWAP_CELEBA

        bench_kw.update(remove_tar=HEAD_SWAP_CELEBA, preserve_src=HEAD_SWAP_CELEBA)
    ds = TestBenchDataset(TestBenchConfig(**bench_kw))
    loader = PrefetchLoader(ds, batch_size=args.n_samples, shuffle=False, drop_last=False)

    os.makedirs(os.path.join(args.outdir, "results"), exist_ok=True)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    done, times = 0, []
    t_start = time.perf_counter()
    for batch in loader:
        t0 = time.perf_counter()
        b = batch["target_image"].shape[0]
        if b < args.n_samples:  # pad the ragged tail to the batch size
            pad = args.n_samples - b
            batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                     for k, v in batch.items()}
        tgt = batch["target_image"]
        prior = None
        if args.prior_dir:
            prior = batch["prior_image"]
        elif args.start_from_target:
            prior = tgt  # prior == GT when no prior dir is loaded
        out = swapper.swap(
            target_image=tgt, inpaint_image=batch["inpaint_image"],
            inpaint_mask=batch["inpaint_mask"], ref_clip224=batch["ref_clip224"],
            landmarks=landmark_fn(tgt) if landmark_fn is not None else None,
            generator=generator, prior_image=prior)
        if safety is not None:
            out01, flags = safety((out + 1.0) / 2.0)
            out = out01 * 2.0 - 1.0
            # count only the real rows (the padded tail repeats the last item)
            nflag = int(flags[:b].sum())
            if nflag:
                print(f"[test_bench] safety checker flagged {nflag} images")
        out = out[:b].cpu().numpy()
        for i in range(b):
            tid, sid = int(batch["target_id"][i]), int(batch["source_id"][i])
            save_image_pm1(os.path.join(args.outdir, "results", f"{sid}_{tid}.png"), out[i])
            if args.save_aux:
                save_image_pm1(os.path.join(args.outdir, "GT", f"{tid}.png"),
                               batch["target_image"][i])
                save_image_pm1(os.path.join(args.outdir, "inpaint", f"{tid}.png"),
                               batch["inpaint_image"][i])
                save_image_pm1(os.path.join(args.outdir, "mask", f"{tid}.png"),
                               np.repeat(batch["inpaint_mask"][i] * 2 - 1, 3, axis=-1))
                save_grid_pm1(os.path.join(args.outdir, "grid", f"{sid}_{tid}.png"),
                              [batch["target_image"][i], batch["inpaint_image"][i], out[i]])
        done += b
        times.append(time.perf_counter() - t0)
        rate = done / (time.perf_counter() - t_start)
        print(f"[test_bench] {done}/{len(ds)} swaps ({rate:.2f} swaps/s)")
    seconds = time.perf_counter() - t_start
    print(f"[test_bench] wrote {done} swaps to {args.outdir} in {seconds:.2f} s "
          f"({done / seconds:.2f} swaps/s)")
    return times, seconds


if __name__ == "__main__":
    main()
