"""Full-loss training steps back to back through make_train_step's
train_step.

Set-up builds one training step with its model and optimizer state from
the seed, and drives it through its first three steps, each on rows of
its own and with draws of its own (t, the noise, the CFG drop, the two
posterior normals) made from the seed; the window's steps continue on the
same object, cycling through the pool of batches. Losses stay on the card
during the window and are read after it.

The check follows the first three steps with the fp32 reference
(gpubench/reference/train.py) on the same weights, rows and draws, once the
program is freed, and compares, each by the worst case: each step's loss
(relative gap); the norm of each trainable leaf's first gradient as the
optimizer got it (its first moment after one step over 1 - b1) against the
reference's gradient; the norm of each leaf's change after the three steps
against the reference's. A leaf's gap in norm is measured against the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the change.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import torch

from gpubench import flops, inputs, weights
from gpubench.drivers.swap import program_config
from gpubench.harness import sub_seed
from gpubench.reference import nets
from gpubench.reference.train import TrainReference, loss, run_steps

TOWERS = ("unet", "vae", "conditioner", "lpips")
CHECK_STEPS = 3
B1 = 0.9
NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def train_configs(cfg: dict):
    """The program's (SwapConfig, TrainConfig, ReconLossConfig)."""
    from reface_tpu_torch.pipelines.train import ReconLossConfig, TrainConfig

    tc, rc = cfg["train"], cfg["recon"]
    tcfg = TrainConfig(learning_rate=tc["learning_rate"], warmup_steps=cfg["warmup_steps"],
                       weight_decay=tc["weight_decay"], u_cond_percent=tc["u_cond_percent"],
                       force_unet_remat=tc["unet_remat"])
    recon = ReconLossConfig(ddim_steps=rc["ddim_steps"], id_weight=rc["id_weight"],
                            lpips_weight=rc["lpips_weight"], lpips_scales=tuple(rc["lpips_scales"]),
                            flip_reference=rc["flip_reference"])
    return program_config(cfg), tcfg, recon


def reference_meta(cfg: dict) -> TrainReference:
    with torch.device("meta"):
        return TrainReference(cfg)


def program_dtypes(cfg: dict) -> dict:
    from reface_tpu_torch.pipelines.train import TrainModules, resolve_train_swap_cfg

    scfg, tcfg, recon = train_configs(cfg)
    mods = TrainModules(resolve_train_swap_cfg(scfg, tcfg, recon), "meta", lpips=True)
    return {f"{t}.{k}": v.dtype for t, m in mods.towers().items() for k, v in m.state_dict().items()}


def make_draws(cfg: dict, batch: int, seed: int, device) -> dict:
    """One step's draws in the program's layout (latents NHWC)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = cfg["latent_size"]
    kw = dict(generator=gen, device=device)
    return {"t": torch.randint(0, 1000, (batch,), **kw),
            "noise": torch.randn((batch, h, h, 4), **kw),
            "drop": torch.rand((batch,), **kw) < cfg["train"]["u_cond_percent"],
            "eps_target": torch.randn((batch, h, h, 4), **kw),
            "eps_inpaint": torch.randn((batch, h, h, 4), **kw)}


@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    dtypes: dict
    step_fn: object
    train: object  # the program's TrainState
    pool: list
    first: dict = dataclasses.field(default_factory=dict)  # the first steps' readings
    losses: list = dataclasses.field(default_factory=list)
    steps: int = 0
    diagnostics: dict = dataclasses.field(default_factory=dict)  # the check's further readings


def _draw(state: State, i: int) -> dict:
    return make_draws(state.cfg, state.traffic["batch"], sub_seed(state.seed, 1000 + i), state.device)


def _step(state: State, i: int):
    _, metrics = state.step_fn(state.train, state.pool[i % len(state.pool)], _draw(state, i))
    return metrics["loss"]


def setup(cfg: dict, traffic: dict, seed: int, device, control: bool = False) -> State:
    from reface_tpu_torch.pipelines.train import make_train_step

    if control:
        raise ValueError("the training cells' control is the reference in fp8 (gpubench.calibrate)")
    device = torch.device(device)
    if device.type == "cuda":
        from reface_tpu_torch.ops import kernels

        kernels.build()
    scfg, tcfg, recon = train_configs(cfg)
    step_fn, _, init_state = make_train_step(scfg, tcfg, recon, device=device)
    dtypes = program_dtypes(cfg)
    sd = weights.make_state(reference_meta(cfg), sub_seed(seed, 0), device, dtypes)
    train = init_state(weights.split_towers(sd, TOWERS))
    del sd
    b, n = traffic["batch"], traffic["pool_batches"]
    pairs = inputs.make_pairs(b * n, cfg["image_size"], sub_seed(seed, 1), device)
    pool = [inputs.rows(pairs, slice(i * b, (i + 1) * b)) for i in range(n)]
    state = State(cfg, traffic, seed, device, dtypes, step_fn, train, pool)
    # the first steps: the warm-up, and what the check follows
    opt = train.opt
    with torch.no_grad():
        p0 = [p.detach().clone() for p in opt.params]
    losses = []
    for i in range(CHECK_STEPS):
        losses.append(_step(state, i))
        if i == 0:
            g1 = torch.stack(torch._foreach_norm(opt.mu)) / (1.0 - B1)
    with torch.no_grad():
        change = torch.stack(torch._foreach_norm(torch._foreach_sub(opt.params, p0)))
    del p0
    state.first = {"names": list(opt.names), "losses": [float(x) for x in losses],
                   "g1": g1.tolist(), "change": change.tolist()}
    state.steps = CHECK_STEPS
    return state


def _sync(state: State):
    if state.device.type == "cuda":
        torch.cuda.synchronize()


def window(state: State, seconds: float) -> dict:
    """Steps back to back; the window runs from the first dispatch to the
    synchronise after the last step that began before `seconds`."""
    _sync(state)
    t0 = time.perf_counter()
    done = 0
    while done == 0 or time.perf_counter() - t0 < seconds:
        state.losses.append(_step(state, state.steps))
        state.steps += 1
        done += 1
        _sync(state)
    t1 = time.perf_counter()
    return {"units": done * state.traffic["batch"], "seconds": t1 - t0, "steps": done}


def profile(state: State) -> int:
    """traffic["profile_steps"] more steps, for the profiler; returns their
    number."""
    for _ in range(state.traffic["profile_steps"]):
        _step(state, state.steps)
        state.steps += 1
    _sync(state)
    return state.traffic["profile_steps"]


def outcomes(state: State) -> tuple[int, int]:
    """(steps in the window, steps whose loss is not finite)."""
    if not state.losses:
        return 0, 0
    losses = torch.stack([x.float() for x in state.losses])
    return len(state.losses), int((~torch.isfinite(losses)).sum())


# ------------------------------------------------------------------ the check

def reference_readings(cfg: dict, traffic: dict, seed: int, device, dtypes: dict, fp8: bool = False,
                       half: bool = False) -> dict:
    """The reference's losses, first gradients' and changes' norms over the
    first CHECK_STEPS steps, by leaf. fp8: the control (every product's
    operands in fp8); half: the fault that leaves out half of each batch
    (the mean taken over the rest)."""
    with torch.device(device):
        ref = TrainReference(cfg)
    ref.load_state_dict(weights.make_state(reference_meta(cfg), sub_seed(seed, 0), device, dtypes))
    if fp8:
        nets.set_fake_fp8(ref)
    b, n = traffic["batch"], traffic["pool_batches"]
    pairs = inputs.make_pairs(b * n, cfg["image_size"], sub_seed(seed, 1), device)
    keep = b // 2 if half else b
    batches, draws = [], []
    for i in range(CHECK_STEPS):
        batches.append(inputs.to_nchw(inputs.rows(pairs, slice(i % n * b, i % n * b + keep))))
        d = make_draws(cfg, b, sub_seed(seed, 1000 + i), device)
        draws.append({k: (v.permute(0, 3, 1, 2).contiguous() if v.dim() == 4 else v)[:keep]
                      for k, v in d.items()})
    p0 = {k: p.detach().clone() for k, p in ref.trainable().items()}
    g1 = {}

    def first(i, grads):
        if i == 0:
            g1.update({k: float(g.norm()) if g is not None else 0.0 for k, g in grads.items()})

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        losses = run_steps(ref, batches, draws, block=traffic["reference_block"], on_grads=first)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    with torch.no_grad():
        change = {k: float((p - p0[k]).norm()) for k, p in ref.trainable().items()}
    return {"losses": losses, "g1": g1, "change": change}


def compare(got: dict, want: dict) -> dict:
    """The three numbers the check compares (the module docstring)."""
    names = list(want["g1"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    med_g = statistics.median(want["g1"][k] for k in names)
    grad_gap = max(abs(got["g1"][k] - want["g1"][k]) / max(want["g1"][k], med_g) for k in names)
    moving = [k for k in names if want["g1"][k] >= 1e-3 * med_g]
    med_c = statistics.median(want["change"][k] for k in moving)
    change_gap = max(abs(got["change"][k] - want["change"][k]) / max(want["change"][k], med_c)
                     for k in moving)
    worst = lambda d, keys, med: max(keys, key=lambda k: abs(got[d][k] - want[d][k]) / max(want[d][k], med))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "worst_grad_leaf": worst("g1", names, med_g), "worst_change_leaf": worst("change", moving, med_c),
            "left_out": len(names) - len(moving), "losses": list(got["losses"]),
            "reference_losses": list(want["losses"])}


def program_readings(state: State) -> dict:
    f = state.first
    return {"losses": f["losses"], "g1": dict(zip(f["names"], f["g1"])),
            "change": dict(zip(f["names"], f["change"]))}


def check(state: State, limits: dict) -> list[tuple[str, float, float]]:
    got = program_readings(state)
    state.train = state.step_fn = None
    state.losses = [float(x) for x in state.losses]
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_readings(state.cfg, state.traffic, state.seed, state.device, state.dtypes)
    gaps = compare(got, want)
    state.diagnostics = {k: v for k, v in gaps.items() if k not in NUMBERS}
    return [(k, gaps[k], float(limits[k])) for k in NUMBERS]


# ------------------------------------------------------------------ arithmetic for the readers

def flops_per_step(cfg: dict, batch: int) -> float:
    """Model FLOPs of one step as the program runs it: the forwards, the
    recomputation of the rematerialised blocks, the backward (counted
    over the reference, whose remat follows the program's)."""
    ref = reference_meta(cfg).freeze()
    m, s, h = flops.meta, cfg["image_size"], cfg["latent_size"]
    rows = {"target": m(batch, 3, s, s), "inpaint": m(batch, 3, s, s), "mask": m(batch, 1, s, s),
            "ref_clip224": m(batch, 3, 224, 224), "landmarks": m(batch, 136)}
    draws = {"t": torch.zeros(batch, dtype=torch.long, device="meta"), "noise": m(batch, 4, h, h),
             "drop": torch.zeros(batch, dtype=torch.bool, device="meta"),
             "eps_target": m(batch, 4, h, h), "eps_inpaint": m(batch, 4, h, h)}
    return float(flops.count(lambda: loss(ref, rows, m(batch, 3, 224, 224), draws, batch).backward()))


def flops_per_unit(cfg: dict, traffic: dict) -> float:
    return flops_per_step(cfg, traffic["batch"]) / traffic["batch"]


def attention_calls_per_step(cfg: dict, batch: int):
    """[(FLOPs, bytes)] of a full-loss step's attention-kernel calls: the two
    VAE encodes (no residuals); each UNet pass's self-attentions of 1024
    tokens or more (the program's FlashAttention; shorter ones are plain
    products), forward twice under remat and backward once, for the eps
    pass and each reconstruction step; the decoder's mid-block (FlashAttention
    at the VAE's widest channels): the noisy latent's decode once forward,
    the two others' forward, recomputed forward and backward."""
    h, u = cfg["latent_size"], cfg["unet"]
    vae_d = cfg["vae"]["ch"] * cfg["vae"]["ch_mult"][-1]
    n_vae = h * h
    calls = [flops.attention_call(batch, n_vae, n_vae, vae_d, "fwd")] * 2
    passes = 1 + cfg["recon"]["ddim_steps"]
    for n, d in flops.unet_self_attention_layers(u, h):
        if n >= 1024:
            bh = batch * u["num_heads"]
            calls += [flops.attention_call(bh, n, n, d, "fwd_lse")] * (2 * passes)
            calls += [flops.attention_call(bh, n, n, d, "bwd")] * passes
    calls += [flops.attention_call(batch, n_vae, n_vae, vae_d, "fwd_lse")] * 5
    calls += [flops.attention_call(batch, n_vae, n_vae, vae_d, "bwd")] * 2
    return calls


def profiled_attention_calls(state: State):
    return attention_calls_per_step(state.cfg, state.traffic["batch"]) * state.traffic["profile_steps"]


def faults(cfg: dict, traffic: dict, seed: int, device, kinds) -> dict:
    """{kind: the check's numbers} for the reference put in the program's
    place with kind "control" (fp8 products) or "half" (half of each
    batch left out), against the fp32 reference."""
    dtypes = program_dtypes(cfg)
    want = reference_readings(cfg, traffic, seed, device, dtypes)
    out = {}
    for kind in kinds:
        got = reference_readings(cfg, traffic, seed, device, dtypes, fp8=kind == "control", half=kind == "half")
        out[kind] = compare(got, want)
    return out
