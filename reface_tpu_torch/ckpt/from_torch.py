"""The reference's torch checkpoints -> the port's state dicts (the reading
half of reface_tpu/ckpt/convert.py).

The port's modules carry the reference checkpoints' key names
(tests/test_torch_port_models.py proves it against the JAX converter), so
nothing is renamed here: keys are routed to their tower and checked.

- `reface_state_dicts`: a REFace `last.ckpt` (ldm/models/diffusion/ddpm.py
  layout) -> the {"unet", "vae", "conditioner"} state dicts that
  `FaceSwapper.load_params` takes: the UNet under `model.diffusion_model.`,
  the VAE under `first_stage_model.`, the conditioner's keys as they stand
  (`cond_stage_model.*`, `face_ID_model.facenet.*`, the projections and the
  null token); a standalone HF CLIP file is merged under
  `cond_stage_model.`, a standalone ArcFace file replaces
  `face_ID_model.facenet.*`. Every other key is ignored, as the JAX converter
  ignores it: `model_ema.*` (LitEma's dot-less names), the CLIP text tower,
  and the Lightning entries around the state dict.
- `bisenet_state_dict`: face-parsing's `79999_iter.pth`.
- `safety_state_dict`: diffusers' StableDiffusionSafetyChecker.
- The eval towers (eval/backbones.py, eval/fid.py): `clip_vision_state_dict`
  (an HF CLIPModel file, e.g. ViT-B/32; the text tower is ignored),
  `hopenet_state_dict` (its unused `fc_finetune` head dropped by name and
  listed; any other key the net lacks raises), `facerecon_state_dict`
  (Deep3DFaceRecon's `epoch_20.pth`: `net_recon.backbone.*` and the seven
  `net_recon.final_layers.*`, nested under "net_recon" or flat, or the
  flat `conv1.*` / `final_layers.*` the JAX evaluate driver reads) and
  `arcface_state_dict` (`model_ir_se50.pth`).
- `expand_conv_in`: zero-pad a 4-channel SD conv_in to REFace's 9.
- `load_swap_params` / `save_swap_params`: the port's own three state dicts
  in one torch file (`--save-params`, read back by `--ckpt`; the params
  file of a training checkpoint, ckpt/io.py, is read the same way).
- `lpips_state_dict`: LPIPS(alex) weights in the two layouts the JAX
  convert_lpips reads: a full module dump of the reference's LPIPS, or
  torchvision's AlexNet merged with the official lin layers.

A key the tower needs and the file lacks raises CheckpointError naming the
first 20; so does a tensor of the wrong shape (a 4-channel SD conv_in
included, as in the JAX package: expand it first). Floating tensors come
back in float32, as the JAX converter gives them; load_state_dict casts to
each module's storage dtype.
"""

from __future__ import annotations

import re
import zipfile
from typing import Mapping

import torch

__all__ = ["CheckpointError", "load_torch_state_dict", "expand_conv_in",
           "reface_state_dicts", "bisenet_state_dict", "safety_state_dict",
           "clip_vision_state_dict", "hopenet_state_dict", "facerecon_state_dict",
           "arcface_state_dict", "lpips_state_dict", "vae_state_dict",
           "load_swap_params", "save_swap_params", "is_swap_params", "UNET_PREFIX",
           "VAE_PREFIX"]

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
_CLIP_PREFIX = "cond_stage_model."
_ARCFACE_PREFIX = "face_ID_model.facenet."
_TOWERS = ("unet", "vae", "conditioner")


class CheckpointError(KeyError):
    """A checkpoint lacks a key a module needs, or holds a wrong shape."""


def load_torch_state_dict(path) -> dict:
    """A torch checkpoint's state dict on the CPU, its `"state_dict"` entry
    unwrapped (Lightning's layout).

    The file is unpickled with weights_only=False, as the JAX package reads
    it: a Lightning `last.ckpt` holds more than tensors (hyper-parameters,
    optimizer states). Load only files you trust. A zip-format file (every
    torch.save since 1.6) is memory-mapped, so a multi-GB checkpoint is
    paged in as its tensors are read; an older file is read whole."""
    obj = torch.load(path, map_location="cpu", weights_only=False,
                     mmap=zipfile.is_zipfile(path))
    if isinstance(obj, dict):
        return dict(obj.get("state_dict", obj))
    return obj


def expand_conv_in(sd: dict, in_channels: int = 9,
                   key: str = UNET_PREFIX + "input_blocks.0.0.weight") -> dict:
    """Zero-pad a vanilla SD conv_in from 4 to `in_channels` input channels
    (the reference's scripts/modify_checkpoints.py)."""
    out = dict(sd)
    w = out[key]
    if w.shape[1] >= in_channels:
        return out
    pad = torch.zeros((w.shape[0], in_channels - w.shape[1]) + tuple(w.shape[2:]), dtype=w.dtype)
    out[key] = torch.cat([w, pad], dim=1)
    return out


def _select(module: torch.nn.Module, source: Mapping, what: str) -> dict:
    """The entries of `source` that `module`'s state dict names, shape-checked,
    floating ones as float32. A BatchNorm's `num_batches_tracked`, which
    files saved before torch 0.4.1 lack, becomes 0 as torch's BatchNorm
    loads it; any other missing key raises CheckpointError."""
    want = module.state_dict()
    source = {**{k: torch.zeros((), dtype=torch.long) for k in want
                 if k.endswith(".num_batches_tracked") and k not in source}, **source}
    missing = [k for k in want if k not in source]
    if missing:
        lines = "\n".join(f"  {k}" for k in missing[:20])
        raise CheckpointError(f"{what}: {len(missing)} keys missing (first 20):\n{lines}")
    out = {}
    for k, ref in want.items():
        v = source[k]
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v)
        if tuple(v.shape) != tuple(ref.shape):
            raise CheckpointError(f"{what}: shape mismatch {k}: {tuple(v.shape)} vs "
                                  f"{tuple(ref.shape)}")
        out[k] = v.float() if v.is_floating_point() else v
    return out


def _strip(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def reface_state_dicts(cfg, sd: Mapping, clip_sd: Mapping | None = None,
                       arcface_sd: Mapping | None = None) -> dict:
    """A REFace last.ckpt state dict (plus standalone CLIP / ArcFace state
    dicts) -> {"unet", "vae", "conditioner"} state dicts for SwapConfig cfg
    (the JAX convert_reface_checkpoint)."""
    from reface_tpu_torch.pipelines.swap import SwapModules

    towers = SwapModules(cfg, device="meta").towers()
    cond_src = dict(sd)
    if clip_sd:
        cond_src.update({_CLIP_PREFIX + (k if k.startswith("model.") else f"model.{k}"): v
                         for k, v in clip_sd.items()})
    if arcface_sd:
        cond_src = {k: v for k, v in cond_src.items() if not k.startswith(_ARCFACE_PREFIX)}
        cond_src.update({_ARCFACE_PREFIX + k: v for k, v in arcface_sd.items()})
    return {"unet": _select(towers["unet"], _strip(sd, UNET_PREFIX), "unet"),
            "vae": _select(towers["vae"], _strip(sd, VAE_PREFIX), "vae"),
            "conditioner": _select(towers["conditioner"], cond_src, "conditioner")}


def vae_state_dict(sd: Mapping, config=None) -> tuple[dict, str]:
    """(the VAE's state dict, the prefix found) from a torch state dict: a
    full SD / REFace checkpoint nests it under `first_stage_model.`, a
    standalone dump does not (the JAX cli/train_vae.py's detection)."""
    from reface_tpu_torch.nn.vae import AutoencoderKL, VAEConfig

    prefix = VAE_PREFIX if any(k.startswith(VAE_PREFIX) for k in sd) else ""
    return (_select(AutoencoderKL(config or VAEConfig(), device="meta"),
                    _strip(sd, prefix), "vae"), prefix)


def bisenet_state_dict(sd: Mapping, config=None) -> dict:
    """face-parsing's 79999_iter.pth (cp.*, ffm.*, conv_out*) -> the port's
    BiSeNet state dict (the JAX convert_bisenet)."""
    from reface_tpu_torch.nn.bisenet import BiSeNet, BiSeNetConfig

    return _select(BiSeNet(config or BiSeNetConfig(), device="meta"), sd, "bisenet")


def safety_state_dict(sd: Mapping, config=None) -> dict:
    """diffusers' StableDiffusionSafetyChecker state dict -> the port's
    SafetyChecker state dict (the JAX convert_safety_checker): the vision
    tower and its projection under `tower.`, the concept and special-care
    embeddings and thresholds as they are."""
    from reface_tpu_torch.nn.safety import SafetyChecker, SafetyCheckerConfig

    src = dict(sd)
    for k, v in sd.items():
        if k.startswith("vision_model.vision_model."):
            src["tower.vision_model." + k[len("vision_model.vision_model."):]] = v
    if "visual_projection.weight" in sd:
        src["tower.visual_projection.weight"] = sd["visual_projection.weight"]
    return _select(SafetyChecker(config or SafetyCheckerConfig(), device="meta"), src, "safety")


def clip_vision_state_dict(sd: Mapping, config=None) -> dict:
    """An HF CLIPModel state dict (`vision_model.*`, `visual_projection.*`,
    with or without a leading `model.`) -> a standalone CLIPVisionTower's
    state dict (the JAX convert_clip_vision); default config: eval's
    CLIP_B32."""
    from reface_tpu_torch.eval.fid import CLIP_B32
    from reface_tpu_torch.nn.clip import CLIPVisionTower

    if any(k.startswith("model.") for k in sd):
        sd = _strip(sd, "model.")
    return _select(CLIPVisionTower(config or CLIP_B32, device="meta"), sd, "clip vision")


def hopenet_state_dict(sd: Mapping) -> tuple[dict, list]:
    """Hopenet's file (torchvision trunk, fc_yaw/fc_pitch/fc_roll and the
    unused fc_finetune) -> (the port's Hopenet state dict, the keys dropped).
    Only `fc_finetune.*` is dropped; another key the net does not have
    raises CheckpointError."""
    from reface_tpu_torch.eval.backbones import Hopenet

    net = Hopenet(device="meta")
    want = net.state_dict()
    dropped = sorted(k for k in sd if k.startswith("fc_finetune."))
    extra = sorted(k for k in sd if k not in want and k not in dropped)
    if extra:
        raise CheckpointError(f"hopenet: {len(extra)} keys the net does not have "
                              f"(first 20): {extra[:20]}")
    return _select(net, sd, "hopenet"), dropped


def facerecon_state_dict(sd: Mapping) -> dict:
    """Deep3DFaceRecon's coefficient net -> the port's FaceReconCoeffNet
    state dict: `net_recon.` (a nested "net_recon" entry, as epoch_20.pth
    holds it, or a key prefix) and the trunk's `backbone.` are stripped;
    the seven 1x1 heads stay `final_layers.0-6`."""
    from reface_tpu_torch.eval.backbones import FaceReconCoeffNet

    if isinstance(sd.get("net_recon"), Mapping):
        sd = sd["net_recon"]
    elif any(k.startswith("net_recon.") for k in sd):
        sd = _strip(sd, "net_recon.")
    sd = {k[len("backbone."):] if k.startswith("backbone.") else k: v for k, v in sd.items()}
    return _select(FaceReconCoeffNet(device="meta"), sd, "facerecon")


def arcface_state_dict(sd: Mapping, config=None) -> dict:
    """The reference's `model_ir_se50.pth` -> the port's IRSE50 state dict
    (the JAX convert_arcface)."""
    from reface_tpu_torch.nn.arcface import ArcFaceConfig, IRSE50

    return _select(IRSE50(config or ArcFaceConfig(), device="meta"), sd, "arcface")


def lpips_state_dict(sd: Mapping) -> dict:
    """Pretrained LPIPS(alex) -> the port's LPIPS state dict (the JAX
    _lpips_normalize_keys + convert_lpips). Reads a full module dump
    (`net.layers.{0,3,6,8,10}.*`, `lin.{i}.1.weight`) or a merged dict of
    torchvision's AlexNet (`features.{0,3,6,8,10}.*`) and the official lin
    calibration (`lin{i}.model.1.weight`, or `{i}.1.weight` after its
    get_state_dict rename). Other keys (AlexNet's classifier) are ignored."""
    from reface_tpu_torch.nn.lpips import LPIPS

    out = {}
    for k, v in sd.items():
        kk = k[len("net."):] if k.startswith("net.") else k
        if kk.startswith("layers."):
            kk = "features." + kk[len("layers."):]
        m = (re.match(r"lin\.?(\d)\.(?:model\.)?1\.weight$", kk)
             or re.match(r"(\d)\.1\.weight$", kk))
        if m:
            kk = f"lin.{m.group(1)}.1.weight"
        elif kk.startswith("features."):
            kk = "net.layers." + kk[len("features."):]
        out[kk] = v
    return _select(LPIPS(device="meta"), out, "lpips")


def save_swap_params(path, params: Mapping) -> None:
    """Write the port's {"unet", "vae", "conditioner"} state dicts to one
    torch file (on the CPU), for `load_swap_params` / `--ckpt`."""
    torch.save({name: {k: v.detach().cpu() for k, v in params[name].items()}
                for name in _TOWERS}, path)


def is_swap_params(obj) -> bool:
    """Whether a loaded object is the port's own state dicts: the three
    towers, and perhaps the trainer's others ("lpips", "landmark_head", in a
    ckpt/io.py checkpoint), which load_swap_params passes over."""
    return (isinstance(obj, dict) and set(_TOWERS) <= set(obj)
            and all(isinstance(v, dict) for v in obj.values()))


def load_swap_params(cfg, path, clip_path=None, arcface_path=None) -> dict:
    """{"unet", "vae", "conditioner"} state dicts from a torch file: the
    port's own (`save_swap_params`) or a REFace last.ckpt with optional
    standalone CLIP and ArcFace files."""
    from reface_tpu_torch.pipelines.swap import SwapModules

    sd = load_torch_state_dict(path)
    if is_swap_params(sd):
        towers = SwapModules(cfg, device="meta").towers()
        return {name: _select(towers[name], sd[name], name) for name in _TOWERS}
    clip_sd = load_torch_state_dict(clip_path) if clip_path else None
    arcface_sd = load_torch_state_dict(arcface_path) if arcface_path else None
    return reface_state_dicts(cfg, sd, clip_sd, arcface_sd)
