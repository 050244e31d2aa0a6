"""Evaluation driver (port of reface_tpu/cli/evaluate.py): CLIP-FID, ID
retrieval, pose and expression over a results directory against the
dataset, as the reference's evaluate_all.sh runs them, with the reference's
preprocessing (eval/protocol.py):

  - FID compares the results directory with the DATASET image directory
    (evaluate_all.sh:50-53), CLIP's bicubic resize to 224 and centre crop,
    featurised in chunks of 256 images.
  - ID retrieval embeds the dataset rule's MASKED 112 px crops of the
    sources (each by its own mask) and of the swaps (each by its target's
    mask) through the IDLoss pool-and-crop protocol.
  - Pose and expression use the reference's tensor-Resize and bicubic-512
    loads of the target and the swap.

The towers' weights come from the reference's files through --*-ckpt
(ckpt/from_torch.py reads them as they are), or are seeded random for a
smoke run (--allow-random). The JAX package's flags are kept, except that
--backend is --device: the towers run on the card unless asked for the CPU,
and the driver raises without a card.

Usage:
  python -m reface_tpu_torch.cli.evaluate --results-dir out/results \\
      --dataset-dir dataset/FaceData/CelebAMask-HQ --dataset celeba \\
      --metrics fid id pose expression --clip-ckpt clip-vit-base-patch32.bin \\
      --arcface-ckpt model_ir_se50.pth --hopenet-ckpt hopenet_robust_alpha1.pkl \\
      --facerecon-ckpt epoch_20.pth
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time

import numpy as np

PAIR_RE = re.compile(r"(\d+)_(\d+)\.png$")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--results-dir", required=True, help="dir of {source}_{target}.png swaps")
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--dataset", default="celeba", choices=["celeba", "ffhq", "ff"])
    ap.add_argument("--metrics", nargs="+", default=["fid", "id", "pose", "expression"])
    ap.add_argument("--allow-random", action="store_true",
                    help="seeded random eval towers (smoke only)")
    ap.add_argument("--arcface-ckpt", default=None)
    ap.add_argument("--clip-ckpt", default=None)
    ap.add_argument("--hopenet-ckpt", default=None)
    ap.add_argument("--facerecon-ckpt", default=None)
    ap.add_argument("--out", default=None, help="write metrics JSON here")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--fid-limit", type=int, default=0,
                    help="cap the FID dataset reference set (0 = all)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) or the CPU")
    return ap.parse_args(argv)


def _read_hopenet(sd):
    from reface_tpu_torch.ckpt.from_torch import hopenet_state_dict

    state, dropped = hopenet_state_dict(sd)
    if dropped:
        print(f"[evaluate] hopenet: dropped {dropped} (the unused fine-tuning head)")
    return state


def build_tower(metric: str, ckpt, device, allow_random: bool = False):
    """The eval tower of a metric ("fid": CLIP ViT-B/32, "id": IR-SE-50,
    "pose": Hopenet, "expression": the D3DFR coefficient net) on `device`,
    frozen, with a reference file's weights, or seeded random weights when
    there is no file and `allow_random`."""
    from reface_tpu_torch.ckpt import from_torch as R
    from reface_tpu_torch.eval import CLIP_B32, FaceReconCoeffNet, Hopenet
    from reface_tpu_torch.nn.arcface import ArcFaceConfig, IRSE50
    from reface_tpu_torch.nn.clip import CLIPVisionTower
    from reface_tpu_torch.pipelines.swap import init_params

    make, read = {
        "fid": (lambda: CLIPVisionTower(CLIP_B32, device=device), R.clip_vision_state_dict),
        "id": (lambda: IRSE50(ArcFaceConfig(), device=device), R.arcface_state_dict),
        "pose": (lambda: Hopenet(device=device), _read_hopenet),
        "expression": (lambda: FaceReconCoeffNet(device=device), R.facerecon_state_dict),
    }[metric]
    module = make()
    if ckpt:
        module.load_state_dict(read(R.load_torch_state_dict(ckpt)))
    elif allow_random:
        init_params(module, seed=0)
    else:
        raise SystemExit(f"--ckpt required for the {metric} metric (or --allow-random)")
    return module.eval().requires_grad_(False)


def run(args) -> tuple[dict, dict]:
    """The metrics of args.metrics -> (results, {metric: (images, seconds)}),
    the seconds of each metric from its first read to its last feature."""
    from reface_tpu_torch.data.test_bench import TestBenchConfig
    from reface_tpu_torch.eval import protocol as P
    from reface_tpu_torch.pipelines.swap import resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    bench = TestBenchConfig(dataset_dir=args.dataset_dir, dataset=args.dataset)

    swaps = sorted(glob.glob(os.path.join(args.results_dir, "*.png")))
    if args.limit:
        swaps = swaps[: args.limit]
    if not swaps:
        raise SystemExit(f"no swaps found in {args.results_dir}")
    pairs = []
    for p in swaps:
        m = PAIR_RE.search(p)
        if m:
            pairs.append((p, int(m.group(1)), int(m.group(2))))
    print(f"[evaluate] {len(pairs)} swap images")
    swap_paths = [p for p, _, _ in pairs]
    tgt_paths = [bench.img_path(t) for _, _, t in pairs]
    results, seconds = {}, {}
    ckpts = {"fid": args.clip_ckpt, "id": args.arcface_ckpt, "pose": args.hopenet_ckpt,
             "expression": args.facerecon_ckpt}

    def tower(metric):
        return build_tower(metric, ckpts[metric], device, args.allow_random)

    if "fid" in args.metrics:
        from reface_tpu_torch.eval import clip_features, clip_fid

        clip = tower("fid")
        # the reference set is the dataset's image directory (evaluate_all.sh:50-53)
        img_dir = os.path.dirname(bench.img_path(0))
        ds_paths = sorted(q for ext in ("*.jpg", "*.png")
                          for q in glob.glob(os.path.join(img_dir, ext)))
        if args.fid_limit:
            ds_paths = ds_paths[: args.fid_limit]
        if not ds_paths:
            raise SystemExit(f"no dataset images found in {img_dir}")

        def feats_chunked(paths, chunk=256):
            # a dataset directory of 30k images is ~18 GB as one float32 array
            return np.concatenate([clip_features(clip, P.clip_fid_load(paths[i:i + chunk]))
                                   for i in range(0, len(paths), chunk)], axis=0)

        t0 = time.perf_counter()
        results["clip_fid"] = clip_fid(feats_chunked(swap_paths), feats_chunked(ds_paths))
        seconds["fid"] = (len(swap_paths) + len(ds_paths), time.perf_counter() - t0)

    if "id" in args.metrics:
        from reface_tpu_torch.eval import id_retrieval_metrics

        model = tower("id")
        # sources: unique ids masked by their own parsing mask; swaps: by
        # the TARGET's mask (ID_retrieval.py:171-250, evaluate_all.sh)
        t0 = time.perf_counter()
        src_ids = sorted({s for _, s, _ in pairs})
        src_index = {s: i for i, s in enumerate(src_ids)}
        preserve_key = {"ff": "ff++"}.get(args.dataset, args.dataset)
        src112 = P.id_masked_112_load([bench.img_path(s) for s in src_ids],
                                      [bench.mask_path(s) for s in src_ids], preserve_key)
        swap112 = P.id_masked_112_load(swap_paths, [bench.mask_path(t) for _, _, t in pairs],
                                       preserve_key)
        f_src = P.id_embed_protocol(model, src112)
        f_swap = P.id_embed_protocol(model, swap112)
        true_idx = np.array([src_index[s] for _, s, _ in pairs])
        results.update(id_retrieval_metrics(f_swap, f_src, true_idx))
        seconds["id"] = (len(src_ids) + len(swap_paths), time.perf_counter() - t0)

    if "pose" in args.metrics:
        from reface_tpu_torch.eval import pose_angles, pose_l2

        model = tower("pose")
        t0 = time.perf_counter()
        a_t = pose_angles(model, P.hopenet_load(tgt_paths))
        a_s = pose_angles(model, P.hopenet_load(swap_paths))
        results["pose_l2_deg"] = pose_l2(a_t, a_s)
        seconds["pose"] = (2 * len(pairs), time.perf_counter() - t0)

    if "expression" in args.metrics:
        from reface_tpu_torch.eval import expression_coeffs, expression_l2

        model = tower("expression")
        t0 = time.perf_counter()
        e_t = expression_coeffs(model, P.expression_load(tgt_paths))
        e_s = expression_coeffs(model, P.expression_load(swap_paths))
        results["expression_l2"] = expression_l2(e_t, e_s)
        seconds["expression"] = (2 * len(pairs), time.perf_counter() - t0)

    for name, (n, secs) in seconds.items():
        print(f"[evaluate] {name}: {n} images in {secs:.3f} s ({n / secs:.1f} images/s)")
    return results, seconds


def main(argv=None) -> dict:
    args = parse_args(argv)
    results, _ = run(args)
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
