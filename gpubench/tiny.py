"""Tiny configurations of the cells' models, for the CPU tests: the widths
of the program's tiny_swap_config in fp32, 64 px, two sampler steps."""

from __future__ import annotations

import copy

from gpubench import harness

TINY_MODEL = {
    "dtype": "float32", "image_size": 64, "latent_size": 8, "ddim_steps": 2,
    "unet": {"in_channels": 9, "out_channels": 4, "model_channels": 32, "num_res_blocks": 2,
             "attention_resolutions": [1, 2], "channel_mult": [1, 2], "num_heads": 4,
             "transformer_depth": 1, "context_dim": 768},
    "vae": {"ch": 16, "ch_mult": [1, 2, 2, 2], "num_res_blocks": 1, "z_channels": 4, "embed_dim": 4},
    "clip": {"hidden": 64, "layers": 1, "heads": 4, "patch": 56, "image_size": 224, "projection_dim": 768},
    "arcface": {"depths": [8, 16, 16, 16], "units": [1, 1, 1, 1], "embed_dim": 512},
}
TINY_TRAFFIC = {"batch": 2, "pool_batches": 3, "profile_steps": 1, "reference_block": 1}


def tiny_config(workload: str) -> dict:
    """The cell's configuration at the tiny widths (LPIPS at the scales a
    64 px image keeps)."""
    man = harness.manifest()
    cfg = copy.deepcopy(harness.config(man, harness.entry(man["workloads"], workload)["config"]))
    cfg.update(copy.deepcopy(TINY_MODEL))
    if "recon" in cfg:
        cfg["recon"]["lpips_scales"] = [1, 2]
    return cfg


def tiny_traffic(monkeypatch):
    """Every traffic file read with the tiny batch and pool."""
    data = harness.data

    def small(kind, name):
        d = data(kind, name)
        if kind == "traffic":
            d.update({k: v for k, v in TINY_TRAFFIC.items() if k in d})
        return d

    monkeypatch.setattr(harness, "data", small)
