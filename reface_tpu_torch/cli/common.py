"""Shared CLI plumbing of the port's drivers (port of reface_tpu/cli/common.py):
the model flags, the layered config, model assembly from checkpoints, and
the image helpers.

Every flag of the JAX package keeps its name and default, except that
`--backend` (the JAX platform) is `--device {cuda,cpu}`: the drivers run on
the card unless asked for the CPU, and raise without a card. `--ckpt`
takes a REFace `last.ckpt` (with `--clip-ckpt` / `--arcface-ckpt` for
standalone CLIP and ArcFace files) or the file `--save-params` wrote; the
JAX package's orbax directories need JAX to read and are converted once by
scripts/jax_params_to_torch.py. Images go through io/images.py, not cv2.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from reface_tpu_torch.io.images import imdecode, imread, imwrite, resize_linear

__all__ = ["add_model_args", "resolve_device", "apply_config_node", "resolve_swap_config",
           "refuse_orbax_dir", "read_swap_params", "build_swapper", "build_raw_pipeline", "build_safety_checker",
           "decode_keep_mask", "default_inpaint_mask", "save_image_pm1", "save_grid_pm1"]


def add_model_args(ap):
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default; raises without one) or the CPU")
    ap.add_argument("--config", nargs="*", default=[], help="YAML config(s)")
    ap.add_argument("--ckpt", default=None,
                    help="REFace last.ckpt, or the file --save-params wrote")
    ap.add_argument("--clip-ckpt", default=None, help="HF CLIP state dict")
    ap.add_argument("--arcface-ckpt", default=None, help="ArcFace state dict")
    # sampler flags default to None so that "explicitly set" is detectable:
    # explicit flags beat the YAML (main.py precedence) and apply under --tiny
    ap.add_argument("--ddim-steps", type=int, default=None,
                    help="DDIM steps (default 50)")
    ap.add_argument("--scale", type=float, default=None,
                    help="CFG scale (default 3.0)")
    ap.add_argument("--cfg-steps", type=int, default=None,
                    help="serving mode: CFG only on the first N steps "
                         "(default 0 = reference protocol, CFG every step)")
    ap.add_argument("--attn", default=None,
                    choices=["auto", "fast", "flash", "einsum"],
                    help="self-attention kernel (fast = bf16-prob serving "
                         "mode; see ops/attention.py; default auto)")
    ap.add_argument("--quant", default=None,
                    choices=["none", "int8", "int8conv"],
                    help="serving mode: int8 products in the transformer "
                         "blocks (ops/quant.py; default none)")
    ap.add_argument("--quant-cond", action="store_true",
                    help="serving mode: int8 products in the CLIP conditioner "
                         "tower too (composes with --quant)")
    ap.add_argument("--sampler", default=None, choices=["ddim", "plms", "dpm"],
                    help="dpm = DPM-Solver++(2M) (diffusion/dpm_solver.py); "
                         "(default ddim)")
    ap.add_argument("--discretize", default=None,
                    choices=["uniform", "quad", "lam_uniform"],
                    help="timestep-subset spacing; lam_uniform (logSNR) is "
                         "the grid --sampler dpm wants (default uniform)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tiny", action="store_true",
                    help="random tiny model (smoke runs without weights)")
    ap.add_argument("--save-params", default=None, metavar="PATH",
                    help="after loading, save the towers' state dicts as one "
                         "torch file (fast reload via --ckpt PATH)")
    ap.add_argument("--weights-dtype", default="bfloat16")
    ap.add_argument("--overrides", nargs="*", default=[],
                    help="dotlist config overrides a.b=v")


def resolve_device(args) -> torch.device:
    """--device as a torch device; "cuda" raises when there is no card."""
    from reface_tpu_torch.pipelines.swap import resolve_device as _resolve

    return _resolve(None if args.device == "cuda" else args.device)


def apply_config_node(dc, node: dict):
    """Overlay a YAML/dotlist mapping onto a (frozen) dataclass instance.

    Nested dataclass nodes overlay recursively onto the instance's current
    field value (not the class defaults), so a partial `swap.unet:` node on
    a tiny or base config changes only the listed keys. Lists become tuples,
    and a dtype given by name ("float32") becomes the torch dtype."""
    node = dict(node)
    for k in list(node):
        cur = getattr(dc, k, None)
        if isinstance(node[k], dict) and dataclasses.is_dataclass(cur):
            node[k] = apply_config_node(cur, node[k])
        elif isinstance(node[k], list):
            node[k] = tuple(node[k])
        elif isinstance(cur, torch.dtype) and isinstance(node[k], str):
            node[k] = getattr(torch, node[k])
    return dataclasses.replace(dc, **node)


def resolve_swap_config(args):
    """SwapConfig from layered YAML + dotlist overrides + CLI flags.

    Precedence (main.py:504-506): base YAMLs left to right, then the
    --overrides dotlist, then explicitly set flags (--ddim-steps etc.). The
    YAML schema is SwapConfig's field names, bare or under a `swap:` node.
    """
    from reface_tpu_torch.pipelines.swap import SwapConfig, tiny_swap_config

    if args.tiny:
        base = tiny_swap_config(image_size=64, ddim_steps=args.ddim_steps or 4)
    else:
        base = SwapConfig()
    yaml_keys: set = set()
    if getattr(args, "config", None) or getattr(args, "overrides", None):
        from reface_tpu_torch.core.config import load_config, merge

        node = load_config(args.config or [], args.overrides or [])
        # a sectioned schema (swap:/train:/recon:, cli/train.py's layout) or
        # bare SwapConfig fields: the bare fields merge with the swap:
        # section, and the other sections are ignored here
        sections = ("swap", "train", "recon")
        bare = {k: v for k, v in node.items() if k not in sections}
        merged = merge(bare, node.get("swap", {}))
        yaml_keys = set(merged)
        base = apply_config_node(base, merged)
    cli = {}
    if args.ddim_steps is not None and not args.tiny:
        cli["ddim_steps"] = args.ddim_steps
    if args.scale is not None:
        cli["cfg_scale"] = args.scale
    if args.sampler is not None:
        cli["sampler"] = args.sampler
    if getattr(args, "discretize", None) is not None:
        cli["ddim_discretize"] = args.discretize
    elif (cli.get("sampler", base.sampler) == "dpm"
          and base.ddim_discretize == "uniform"
          and "ddim_discretize" not in yaml_keys):
        # DPM-Solver++'s second order assumes the lam-uniform grid; an
        # explicit --discretize or YAML ddim_discretize still wins
        cli["ddim_discretize"] = "lam_uniform"
    if getattr(args, "cfg_steps", None) is not None:
        cli["cfg_steps"] = args.cfg_steps
    if getattr(args, "quant_cond", False):
        cli["conditioner"] = dataclasses.replace(
            base.conditioner,
            clip=dataclasses.replace(base.conditioner.clip, quant="int8"))
    if (getattr(args, "attn", None) is not None
            or getattr(args, "quant", None) is not None):
        ukw = {}
        if getattr(args, "attn", None) is not None:
            ukw["attn_impl"] = args.attn
        if getattr(args, "quant", None) is not None:
            ukw["quant"] = args.quant
            cli["vae"] = dataclasses.replace(base.vae, quant=args.quant)
        cli["unet"] = dataclasses.replace(base.unet, **ukw)
    if cli:
        base = dataclasses.replace(base, **cli)
    return base


@torch.no_grad()
def _round_weights(modules, dtype: torch.dtype) -> None:
    """Round every float32 parameter and buffer of the state dicts through
    `dtype`: the JAX package casts its float32 params to --weights-dtype."""
    if dtype == torch.float32:
        return
    for m in modules:
        for t in m.state_dict(keep_vars=True).values():
            if t.dtype == torch.float32:
                t.copy_(t.to(dtype))


def refuse_orbax_dir(path: str, flag: str) -> None:
    """SystemExit for a directory that is a JAX (orbax) parameter tree."""
    raise SystemExit(
        f"{flag} {path} is a directory, a JAX (orbax) parameter tree, "
        "which needs JAX to read: convert it once with "
        "scripts/jax_params_to_torch.py and pass the file it writes")


def read_swap_params(cfg, path: str, clip_path=None, arcface_path=None,
                     flag: str = "--ckpt") -> dict:
    """{"unet", "vae", "conditioner"} state dicts from what --ckpt takes: a
    REFace last.ckpt (with standalone CLIP / ArcFace files) or the port's
    params file; a directory (a JAX orbax tree) is refused."""
    from reface_tpu_torch.ckpt.from_torch import load_swap_params

    if os.path.isdir(path):
        refuse_orbax_dir(path, flag)
    return load_swap_params(cfg, path, clip_path, arcface_path)


def build_swapper(args):
    """Resolve config and weights into a ready FaceSwapper on --device."""
    from reface_tpu_torch.ckpt.from_torch import save_swap_params
    from reface_tpu_torch.pipelines.swap import FaceSwapper

    cfg = resolve_swap_config(args)
    device = resolve_device(args)
    params = None
    if args.ckpt is not None:
        params = read_swap_params(cfg, args.ckpt, args.clip_ckpt, args.arcface_ckpt)
    swapper = FaceSwapper(cfg, params, device=device, seed=args.seed)
    if getattr(args, "save_params", None):
        save_swap_params(args.save_params, params or {
            name: m.state_dict() for name, m in swapper.towers().items()})
        print(f"[ckpt] saved the towers' state dicts -> {args.save_params}")
    _round_weights(swapper.towers().values(), getattr(torch, args.weights_dtype))
    return swapper


def build_raw_pipeline(args, swapper, raw_cfg):
    """RawSwapPipeline from the shared raw-driver flags: --landmark-ckpt (a
    torch file of the port's LandmarkNet state dict), --landmark-rert (host
    exact ERT, dlib parity; eager path only), --bisenet-ckpt (face-parsing's
    79999_iter.pth)."""
    from reface_tpu_torch.ckpt.from_torch import bisenet_state_dict, load_torch_state_dict
    from reface_tpu_torch.pipelines.raw import RawSwapPipeline

    bn_params = lm_params = lm_fn = None
    if getattr(args, "bisenet_ckpt", None):
        bn_params = bisenet_state_dict(load_torch_state_dict(args.bisenet_ckpt), raw_cfg.bisenet)
    if getattr(args, "landmark_ckpt", None):
        lm_params = load_torch_state_dict(args.landmark_ckpt)
    if getattr(args, "landmark_rert", None):
        if getattr(args, "fused", False):
            raise SystemExit(
                "--landmark-rert is a host-side (exact ERT) landmark source; "
                "the --fused one-program path cannot call the host. Use the "
                "eager path, or --landmark-ckpt (an ERT-distilled LandmarkNet) "
                "with --fused.")
        from reface_tpu_torch.nn.landmarks import landmark68_fn_from_rert

        lm_fn = landmark68_fn_from_rert(args.landmark_rert)
    return RawSwapPipeline(swapper, raw_cfg, landmark_params=lm_params,
                           bisenet_params=bn_params, landmark_fn=lm_fn,
                           device=swapper.device)


def build_safety_checker(ckpt_path: str | None, device=None):
    """SafetyChecker from diffusers' safety-checker state dict, or None
    (opt-in through --safety-ckpt)."""
    if not ckpt_path:
        return None
    from reface_tpu_torch.ckpt.from_torch import load_torch_state_dict, safety_state_dict
    from reface_tpu_torch.nn.safety import SafetyChecker, SafetyCheckerConfig

    cfg = SafetyCheckerConfig()
    return SafetyChecker(cfg, safety_state_dict(load_torch_state_dict(ckpt_path), cfg),
                         device=device)


def decode_keep_mask(data, size: int) -> np.ndarray:
    """A keep-mask (white = keep) from PNG/JPEG bytes or a file path, as a
    (size, size, 1) float array (the precropped modes of cli/swap.py and
    cli/demo_server.py). Raises ValueError if it cannot be read."""
    try:
        if isinstance(data, (bytes, bytearray)):
            m = imdecode(data, gray=True)
        else:
            m = imread(data, gray=True)
    except OSError as e:
        raise ValueError(f"could not decode mask image: {e}") from e
    m = resize_linear(m, size, size)
    return (m.astype(np.float32) / 255.0)[..., None]


def default_inpaint_mask(size: int) -> np.ndarray:
    """Keep-mask (1 = keep) with a central face-shaped ellipse to inpaint:
    the --precropped fallback without a parser or mask (aligned crops put
    the face around (0.5, 0.55) of the frame)."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32) / size
    ellipse = ((xs - 0.5) / 0.30) ** 2 + ((ys - 0.55) / 0.40) ** 2 <= 1.0
    return 1.0 - ellipse.astype(np.float32)[..., None]


def save_image_pm1(path: str, img) -> None:
    """Save an HWC [-1,1] float image (PNG or JPEG by the extension)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    u8 = np.clip((np.asarray(img) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    imwrite(path, u8)


def save_grid_pm1(path: str, imgs: list) -> None:
    grid = np.concatenate([np.asarray(i) for i in imgs], axis=1)
    save_image_pm1(path, grid)
