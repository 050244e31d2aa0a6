"""Save and load the trainer's parameters and full train state (port of
reface_tpu/ckpt/io.py), with torch.save.

One directory per checkpoint tag, as the JAX package's orbax directories:

- `params.pt`: every tower's state dict, {"unet", "vae", "conditioner"[,
  "lpips"][, "landmark_head"]}, on the CPU. It is the format of
  ckpt/from_torch.py's save_swap_params, so `cli.swap --ckpt <dir>/params.pt`
  reads a trained checkpoint (load_swap_params takes the three swap towers
  and passes over the trainer's others).
- `train_state.pt` (full train state only): the step, the AdamW state
  (`mu`, `nu` and the MultiSteps accumulator by parameter name, the update
  count and the MultiSteps position) and the EMA shadow with its counter.
- `reface_meta.json`: {"step": N}.

Loading writes into the existing modules and tensors in place (copy_), so
no second copy of the state is made on the card; the files are
memory-mapped, so none is made on the host either. A checkpoint whose
structure differs from the target (another set of towers or parameters, a
missing or extra EMA or accumulator, another shape) raises, which the
trainer's resume takes as its cue for the params-only fallback.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import torch

__all__ = ["PARAMS_FILE", "STATE_FILE", "save_params", "load_params",
           "save_train_state", "load_train_state", "checkpoint_files"]

PARAMS_FILE = "params.pt"
STATE_FILE = "train_state.pt"
_META = "reface_meta.json"


def _cpu(sd: Mapping) -> dict:
    return {k: v.detach().cpu() for k, v in sd.items()}


def _save(obj, path: str) -> None:
    """torch.save through a temporary name: a new file (inode) replaces the
    old, so that a checkpoint whose files are hard links of another's
    (cli/train.py links a save at an unchanged step) never changes that one."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def checkpoint_files(path: str) -> list[str]:
    """The files of a checkpoint directory that exist."""
    return [os.path.join(path, f) for f in (PARAMS_FILE, STATE_FILE, _META)
            if os.path.exists(os.path.join(path, f))]


def save_params(path: str, params: Mapping[str, Mapping]) -> None:
    """params: tower name -> state dict."""
    os.makedirs(path, exist_ok=True)
    _save({name: _cpu(sd) for name, sd in params.items()}, os.path.join(path, PARAMS_FILE))


def load_params(path: str) -> dict:
    """tower name -> state dict (CPU, memory-mapped) from a checkpoint
    directory or its params file."""
    if os.path.isdir(path):
        path = os.path.join(path, PARAMS_FILE)
    return _load(path)


@torch.no_grad()
def _copy_into(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor], what: str):
    if set(dst) != set(src):
        missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        raise KeyError(f"{what}: checkpoint lacks {missing[:5]} / has extra {extra[:5]}")
    for k, t in dst.items():
        if t.shape != src[k].shape:
            raise ValueError(f"{what}.{k}: shape {tuple(src[k].shape)} in the "
                             f"checkpoint, {tuple(t.shape)} in the model")
    for k, t in dst.items():
        t.copy_(src[k])


def save_train_state(path: str, state, step: int | None = None) -> None:
    """Full-resume checkpoint of a pipelines.train.TrainState: params +
    optimizer state + step (+ EMA)."""
    step = int(state.step if step is None else step)
    save_params(path, state.params())
    opt = state.opt
    tree = {
        "step": int(state.step),
        "opt": {"mu": dict(zip(opt.names, (m.cpu() for m in opt.mu))),
                "nu": dict(zip(opt.names, (v.cpu() for v in opt.nu))),
                "acc": (None if opt.acc is None
                        else dict(zip(opt.names, (a.cpu() for a in opt.acc)))),
                "count": opt.count, "mini_step": opt.mini_step},
        "ema": (None if state.ema is None
                else {"shadow": _cpu(state.ema.shadow), "updates": state.ema.updates,
                      "decay": state.ema.decay}),
    }
    _save(tree, os.path.join(path, STATE_FILE))
    meta = os.path.join(path, _META)
    if os.path.exists(meta):  # a new file, as _save writes
        os.remove(meta)
    with open(meta, "w") as f:
        json.dump({"step": step}, f, indent=2)


def load_train_state(path: str, state):
    """Restore a save_train_state checkpoint into `state` (a TrainState built
    for the same configuration) in place; returns state."""
    tree = _load(os.path.join(path, STATE_FILE))
    params = load_params(path)
    towers = state.modules.towers()
    if set(params) != set(towers):
        raise KeyError(f"checkpoint towers {sorted(params)}, model towers {sorted(towers)}")
    if (tree["ema"] is None) != (state.ema is None):
        raise KeyError("checkpoint and train state differ in having an EMA")
    opt, saved = state.opt, tree["opt"]
    if (saved["acc"] is None) != (opt.acc is None):
        raise KeyError("checkpoint and optimizer differ in accumulating gradients")
    for name, m in towers.items():
        _copy_into(m.state_dict(keep_vars=True), params[name], name)
    for key in ("mu", "nu") + (("acc",) if opt.acc is not None else ()):
        _copy_into(dict(zip(opt.names, getattr(opt, key))), saved[key], key)
    opt.count, opt.mini_step = int(saved["count"]), int(saved["mini_step"])
    if state.ema is not None:
        _copy_into(state.ema.shadow, tree["ema"]["shadow"], "ema")
        state.ema.updates = int(tree["ema"]["updates"])
    state.step = int(tree["step"])
    return state
