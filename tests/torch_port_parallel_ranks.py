"""Rank processes for the port's parallel tests (no tests here).

`spawn(world, tmp_path, nice, **kw)` starts `world` processes with
torch.multiprocessing (spawn), each at one torch thread and at least the
given nice value, which run `ranks(rank, world, out_dir=tmp_path,
store=..., **kw)`: cli.train over the ranks where `cli_argv` is given (the
driver joins the gloo group from its flags, through a file store under
tmp_path: no port, so pytest-xdist workers cannot collide), then one step
per mesh of `meshes` over the same group, then one data-parallel full-loss
step per level of `split_grads`. The ranks import the port only (never
jax), and rank 0 writes what the test reads with torch.save.
"""

import os

import numpy as np
import torch
import torch.multiprocessing as mp


def _entry(rank, world, nice, kw):
    os.setpriority(os.PRIO_PROCESS, 0, max(nice, os.getpriority(os.PRIO_PROCESS, 0)))
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        ranks(rank, world, **kw)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world: int, tmp_path, nice: int, **kw) -> None:
    """Run `ranks` in `world` spawned processes; raises if any rank fails."""
    kw = dict(kw, out_dir=str(tmp_path), store=os.path.join(str(tmp_path), "store"))
    mp.start_processes(_entry, args=(world, nice, kw), nprocs=world, join=True,
                       start_method="spawn")


# ------------------------------------------------------------ the step

# 128 channels at the second level: its convs shard (the conv rule's floor),
# its transformer (4 heads of 32) runs 2 heads a rank, its GEGLU shards
SMALL = dict(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
             attention_resolutions=(2,))
# a first step that moves the weights well above their fp32 resolution
# (the warmup starts at learning_rate * 1e-6), behind a clip that engages
STEP_TCFG = dict(learning_rate=1e3, grad_clip=1e-2)

# the full loss (the ID term alone: LPIPS adds time, not a path) on
# tiny_swap_config(64, ddim_steps=2), as tests/test_torch_port_split_acc.py
FULL_RECON = dict(ddim_steps=2, lpips_scales=(1, 2), lpips_weight=0.0)


def step_config(cfg_kw: dict | None, split_grad: int = 0):
    """tiny_swap_config(64) with the UNet fields of cfg_kw replaced; at
    split_grad > 0 the full loss's tiny_swap_config(64, ddim_steps=2)."""
    import dataclasses

    from reface_tpu_torch.pipelines.swap import tiny_swap_config

    if split_grad:
        return tiny_swap_config(image_size=64, ddim_steps=FULL_RECON["ddim_steps"])
    cfg = tiny_swap_config(image_size=64)
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, **cfg_kw))


def one_step(mesh, cfg_kw, params, batch, draws, out_path=None, split_grad=0):
    """One train_step of make_train_step(mesh=mesh) on this rank's data
    slice of `batch` (global numpy arrays), fed the global `draws`: returns
    (and on rank 0 saves to out_path) the loss, the metrics, the UNet's and
    the conditioner's gradients and parameters (the UNet's gathered) and
    whether a conv, a self-attention and a GEGLU were sharded; the
    gradients' global norm as the optimizer's clip takes it. split_grad > 0:
    the full-loss step (FULL_RECON) split at that level with the bf16
    accumulator, cfg_kw unused."""
    from reface_tpu_torch.parallel.tp import gather_params_tp
    from reface_tpu_torch.pipelines import train as PT

    tcfg = PT.TrainConfig(**STEP_TCFG, **(dict(split_grad=split_grad, split_acc_dtype="bfloat16")
                                          if split_grad else {}))
    recon = PT.ReconLossConfig(**FULL_RECON) if split_grad else None
    step, _, init_state = PT.make_train_step(step_config(cfg_kw, split_grad), tcfg, recon=recon,
                                             device="cpu", mesh=mesh)
    state = init_state(params)
    b = len(batch["target_image"]) // (1 if mesh is None else mesh.n_data)
    lo = 0 if mesh is None else mesh.data_rank * b
    local = {k: v[lo:lo + b] for k, v in batch.items()}
    state, metrics = step(state, local, draws)
    opt = state.opt
    norm = float(opt._global_norm([torch.zeros_like(p) if p.grad is None else p.grad
                                   for p in opt.params]))
    unet = state.modules.unet
    if mesh is not None and mesh.n_model > 1:
        grads = gather_params_tp(unet, mesh, grads=True)
        values = gather_params_tp(unet, mesh)
    else:
        grads = {k: p.grad for k, p in unet.named_parameters()}
        values = unet.state_dict()
    cond = state.modules.conditioner
    out = {
        "loss": float(metrics["loss"]),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {**{f"unet.{k}": v for k, v in grads.items()},
                  **{f"conditioner.{k}": p.grad for k, p in cond.named_parameters()}},
        "params": {**{f"unet.{k}": v for k, v in values.items()},
                   **{f"conditioner.{k}": v for k, v in cond.state_dict().items()}},
        "sharded": sharded_kinds(unet),
        "grad_norm": norm,
    }
    if out_path is not None and (mesh is None or mesh.rank == 0):
        torch.save(out, out_path)
    return out


def sharded_kinds(unet) -> dict:
    """Which kinds of layer shard_params_tp split: convs, self-attentions
    on their local heads, GEGLU projections."""
    from reface_tpu_torch.parallel import tp

    kinds = {"conv": False, "self_attention": False, "geglu": False}
    for name, m in unet.named_modules():
        if type(m) is tp._ColumnConv2d:
            kinds["conv"] = True
        if type(m) is tp._TPCrossAttention and m.local_heads:
            kinds["self_attention"] = True
        if name.endswith("ff.net.0.proj") and type(m) is tp._ColumnLinear:
            kinds["geglu"] = True
    return kinds


def ranks(rank, world, out_dir, store, meshes=(), cfg_kw=None, cli_argv=None, split_grads=()):
    """cli.train with `cli_argv` and the three flags (its logdir rank{rank}
    under out_dir), then one step per (name, n_data, n_model) of `meshes`
    over the same group, then the full-loss step on a world x 1 mesh per
    level of `split_grads` (saved as split{level}.pt), from the params,
    batch and draws the test saved."""
    from reface_tpu_torch.cli import train as cli_train
    from reface_tpu_torch.parallel import create_mesh, init_distributed

    if cli_argv is not None:
        cli_train.main([*cli_argv, "--coordinator", f"file://{store}", "--num-processes",
                        str(world), "--process-id", str(rank), "--logdir",
                        os.path.join(out_dir, f"rank{rank}")])
    init_distributed(f"file://{store}", world, rank)  # joined already by the driver
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    for name, n_data, n_model in meshes:
        mesh = create_mesh(n_data=n_data, n_model=n_model)
        one_step(mesh, cfg_kw, inputs["params"], inputs["batch"], inputs["draws"],
                 os.path.join(out_dir, f"{name}.pt"))
    for level in split_grads:
        one_step(create_mesh(n_data=world), None, inputs["params"], inputs["batch"],
                 inputs["draws"], os.path.join(out_dir, f"split{level}.pt"), split_grad=level)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
