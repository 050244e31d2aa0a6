#!/usr/bin/env python3
"""Convert JAX-trained parameters (orbax directories) into the PyTorch port's
torch files.

The JAX package saves parameters as orbax directories
(reface_tpu/ckpt/io.py::save_params), which need JAX to read; the port's
drivers read torch files. This script reads a directory with
`reface_tpu.ckpt.io.load_params` and writes, with
`reface_tpu_torch/ckpt/from_jax.py`:

- `--swap DIR --swap-out FILE`: the swap towers' {"unet", "vae",
  "conditioner"} params (what `reface_tpu.cli --save-params` writes) as the
  port's three state dicts (swap_from_jax), for the port's `--ckpt FILE`;
- `--landmark DIR --landmark-out FILE`: a LandmarkNet's params as the
  port's LandmarkNet state dict (landmark_net_from_jax), for
  `--landmark-ckpt FILE`.

It is the one program of the repo that imports both packages; run it where
JAX is installed:

    python scripts/jax_params_to_torch.py --swap params_dir --swap-out swap.pt
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--swap", default=None, help="orbax dir of the swap towers' params")
    ap.add_argument("--swap-out", default=None, help="torch file to write them to")
    ap.add_argument("--landmark", default=None, help="orbax dir of LandmarkNet params")
    ap.add_argument("--landmark-out", default=None, help="torch file to write them to")
    args = ap.parse_args(argv)
    if (args.swap is None) != (args.swap_out is None) or \
            (args.landmark is None) != (args.landmark_out is None):
        ap.error("--swap needs --swap-out and --landmark needs --landmark-out")
    if args.swap is None and args.landmark is None:
        ap.error("nothing to convert: give --swap and/or --landmark")

    import torch

    from reface_tpu.ckpt.io import load_params
    from reface_tpu_torch.ckpt.from_jax import landmark_net_from_jax, swap_from_jax
    from reface_tpu_torch.ckpt.from_torch import save_swap_params

    if args.swap:
        save_swap_params(args.swap_out, swap_from_jax(load_params(args.swap)))
        print(f"[convert] {args.swap} -> {args.swap_out}")
    if args.landmark:
        torch.save(landmark_net_from_jax(load_params(args.landmark)), args.landmark_out)
        print(f"[convert] {args.landmark} -> {args.landmark_out}")


if __name__ == "__main__":
    main()
