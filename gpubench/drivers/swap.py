"""Closed-loop batches of pre-cropped swaps through FaceSwapper.swap.

The traffic file gives the batch, the pool of distinct batches the loop
cycles through, and how many pairs the check recomputes. Each batch's
random draws (the VAE posterior sample, x_T) come from a generator seeded
from the run's seed and the batch's index, which the program receives and
the reference re-creates.

The check: a sample of pairs drawn from the seed among all that the window
returned, recomputed by the fp32 reference (gpubench/reference/swap.py) on
the same weights, inputs and draws, once the program is freed (`check`
says what is compared). The control (`control=True`) is the program's own int8 path
(the UNet, the VAE and CLIP through int8 products).
"""

from __future__ import annotations

import dataclasses
import gc
import random
import time

import torch

from gpubench import flops, inputs, weights
from gpubench.harness import sub_seed
from gpubench.reference import nets
from gpubench.reference.swap import SwapReference

TOWERS = ("unet", "vae", "conditioner")


def program_config(cfg: dict, quant: str = "none"):
    """The program's SwapConfig for a configuration file; quant "int8" runs
    the UNet, the VAE and CLIP through the program's int8 products."""
    from reface_tpu_torch.nn.arcface import ArcFaceConfig
    from reface_tpu_torch.nn.clip import CLIPVisionConfig
    from reface_tpu_torch.nn.conditioner import ConditionerConfig
    from reface_tpu_torch.nn.unet import UNetConfig
    from reface_tpu_torch.nn.vae import VAEConfig
    from reface_tpu_torch.pipelines.swap import SwapConfig

    dt = getattr(torch, cfg["dtype"])
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    c = cfg["conditioner"]
    return SwapConfig(
        unet=UNetConfig(**tup(cfg["unet"]), dtype=dt, fused_groupnorm=cfg["fused_groupnorm"], quant=quant),
        vae=VAEConfig(**tup(cfg["vae"]), dtype=dt, quant=quant),
        conditioner=ConditionerConfig(
            clip_weight=c["clip_weight"], id_weight=c["id_weight"], landmark_weight=c["landmark_weight"],
            context_dim=c["context_dim"], landmark_dim=c["landmark_dim"],
            clip=CLIPVisionConfig(**tup(cfg["clip"]), dtype=dt, quant=quant),
            arcface=ArcFaceConfig(**tup(cfg["arcface"]), dtype=dt)),
        ddim_steps=cfg["ddim_steps"], cfg_scale=cfg["cfg_scale"], eta=cfg["eta"],
        image_size=cfg["image_size"], latent_size=cfg["latent_size"],
        sample_posterior=cfg["sample_posterior"], cfg_dedup=cfg["cfg_dedup"])


def reference_meta(cfg: dict) -> SwapReference:
    with torch.device("meta"):
        return SwapReference(cfg)


def program_dtypes(scfg) -> dict:
    """The dtype the program stores each weight in, from its modules built
    on the meta device."""
    from reface_tpu_torch.pipelines.swap import SwapModules

    mods = SwapModules(scfg, device="meta")
    return {f"{tower}.{k}": v.dtype for tower, m in mods.towers().items() for k, v in m.state_dict().items()}


@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    dtypes: dict
    swapper: object
    pool: list  # batches of pairs (NHWC dicts)
    outs: list = dataclasses.field(default_factory=list)  # (batch index, host copy)
    batches: int = 0
    diagnostics: dict = dataclasses.field(default_factory=dict)  # the check's further readings


def _draw_seed(state: State, i: int) -> int:
    return sub_seed(state.seed, 1000 + i)


def setup(cfg: dict, traffic: dict, seed: int, device, control: bool = False) -> State:
    from reface_tpu_torch.core.schedules import DDIMTables
    from reface_tpu_torch.pipelines.swap import FaceSwapper

    device = torch.device(device)
    if device.type == "cuda":
        from reface_tpu_torch.ops import kernels

        kernels.build()  # every source at once; a checkout's later runs find them built
    scfg = program_config(cfg, "int8" if control else "none")
    dtypes = program_dtypes(scfg)
    state_dict = weights.make_state(reference_meta(cfg), sub_seed(seed, 0), device, dtypes)
    swapper = FaceSwapper(scfg, params=weights.split_towers(state_dict, TOWERS), device=device)
    del state_dict
    b, n = traffic["batch"], traffic["pool_batches"]
    pairs = inputs.make_pairs(b * n, cfg["image_size"], sub_seed(seed, 1), device)
    pool = [inputs.rows(pairs, slice(i * b, (i + 1) * b)) for i in range(n)]
    state = State(cfg, traffic, seed, device, dtypes, swapper, pool)
    # warm-up: the window's shapes with the sampler cut to a few steps
    full = swapper.tables
    swapper.tables = DDIMTables.create(swapper.schedule, traffic["warmup_steps"], eta=cfg["eta"])
    swapper.swap(**pool[0], generator=torch.Generator(device=device).manual_seed(0))
    swapper.tables = full
    return state


def _batch(state: State, i: int):
    gen = torch.Generator(device=state.device).manual_seed(_draw_seed(state, i))
    return state.swapper.swap(**state.pool[i % len(state.pool)], generator=gen)


def _sync(state: State):
    if state.device.type == "cuda":
        torch.cuda.synchronize()


def window(state: State, seconds: float) -> dict:
    """Batches back to back; the window runs from the first dispatch to the
    synchronise after the last batch that began before `seconds`."""
    pin = state.device.type == "cuda"
    _sync(state)
    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < seconds:
        out = _batch(state, i)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=pin)
        host.copy_(out, non_blocking=pin)
        _sync(state)
        state.outs.append((i, host))
        i += 1
    t1 = time.perf_counter()
    state.batches = i
    return {"units": i * state.traffic["batch"], "seconds": t1 - t0, "batches": i}


def profile(state: State) -> int:
    """One more batch, for the profiler; returns the pairs it swapped."""
    _batch(state, state.batches)
    _sync(state)
    return state.traffic["batch"]


def outcomes(state: State) -> tuple[int, int]:
    """(pairs attempted in the window, pairs whose image is not finite, out
    of [-1, 1] or of the wrong shape)."""
    size, b = state.cfg["image_size"], state.traffic["batch"]
    failed = 0
    for _, out in state.outs:
        if tuple(out.shape) != (b, size, size, 3):
            failed += b
            continue
        bad = ~torch.isfinite(out).all(dim=(1, 2, 3)) | (out.abs() > 1.0).any(dim=(1, 2, 3))
        failed += int(bad.sum())
    return state.batches * state.traffic["batch"], failed


def sample(state: State) -> list[tuple[int, int]]:
    """(batch index, row) of the pairs the check recomputes, drawn from the
    seed among every pair the window returned."""
    every = [(i, r) for i, out in state.outs for r in range(min(out.shape[0], state.traffic["batch"]))]
    return sorted(random.Random(sub_seed(state.seed, 2)).sample(every, min(state.traffic["check_pairs"], len(every))))


def reference_draws(state: State, i: int):
    """The draws batch i handed the program, made again: the posterior
    sample's normals, then x_T."""
    b, h = state.traffic["batch"], state.cfg["latent_size"]
    gen = torch.Generator(device=state.device).manual_seed(_draw_seed(state, i))
    post = torch.randn((b, 4, h, h), generator=gen, device=state.device)
    return post, torch.randn((b, 4, h, h), generator=gen, device=state.device)


def check(state: State, limits: dict) -> list[tuple[str, float, float]]:
    """[(name, value, limit)]: the share of the 8-bit values (each channel
    of each pixel, as the test bench writes its images) of a sampled pair
    that lie 3 levels or more from the fp32 reference's, worst pair. The
    relative L2 distance of the images does not separate the program from
    its int8 control by the factor of three the limit needs (PERF.md): the
    sampler's 50 guided steps spread both errors over the image alike,
    where the control's error moves several times more values by whole
    levels."""
    picks = sample(state)
    outs = dict(state.outs)
    got = torch.stack([outs[i][r] for i, r in picks]).to(state.device).float()
    state.swapper = None
    state.outs = []
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_images(state, picks)
    level = lambda x: torch.round((x + 1.0) * 127.5).clamp(0, 255)
    off = (level(got) - level(want)).abs().flatten(1)
    diff = (got - want).flatten(1)
    state.diagnostics = {
        "image_rel_l2": (diff.norm(dim=1) / want.flatten(1).norm(dim=1)).tolist(),
        "share_off_2_levels": (off >= 2).float().mean(dim=1).tolist(),
        "share_off_4_levels": (off >= 4).float().mean(dim=1).tolist(),
    }
    share = float((off >= 3).float().mean(dim=1).max())
    return [("share_off_3_levels", share, float(limits["share_off_3_levels"]))]


def reference_images(state: State, picks) -> torch.Tensor:
    """The fp32 reference's images of the picked pairs, TF32 off."""
    dev = state.device
    with torch.device(dev):
        ref = SwapReference(state.cfg)
    ref.load_state_dict(weights.make_state(reference_meta(state.cfg), sub_seed(state.seed, 0), dev,
                                           state.dtypes))
    ref.eval()
    rows, post, xt = [], [], []
    for i, r in picks:
        batch = state.pool[i % len(state.pool)]
        rows.append(inputs.rows(batch, [r]))
        p, x = reference_draws(state, i)
        post.append(p[r:r + 1])
        xt.append(x[r:r + 1])
    batch = inputs.to_nchw({k: torch.cat([x[k] for x in rows]) for k in rows[0]})
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return ref.swap(batch, torch.cat(post), torch.cat(xt))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ------------------------------------------------------------------ arithmetic for the readers

def flops_per_pair(cfg: dict) -> float:
    """Model FLOPs of one pair as the program runs it: the conditioning,
    the encode, ddim_steps guided UNet evaluations (the pair's two rows,
    less the prefix the CFG dedup runs once) and the decode."""
    ref = reference_meta(cfg)
    m = flops.meta
    s, h = cfg["image_size"], cfg["latent_size"]
    c = cfg["unet"]["context_dim"]
    cond = flops.count(lambda: ref.conditioner(m(1, 3, 224, 224), nets.clip_input(m(1, 3, s, s)), m(1, 136)))
    enc = flops.count(lambda: ref.vae.posterior(m(1, 3, s, s)))
    dec = flops.count(lambda: ref.vae.decode(m(1, 4, h, h)))
    t = torch.zeros(2, dtype=torch.int32, device="meta")
    pair = flops.count(lambda: ref.unet(m(2, cfg["unet"]["in_channels"], h, h), t, m(2, 1, c)))
    if cfg["cfg_dedup"]:
        pair -= _dedup_prefix(ref.unet, cfg, h)
    return float(cond + enc + cfg["ddim_steps"] * pair + dec)


def _dedup_prefix(unet, cfg: dict, h: int) -> int:
    """FLOPs the CFG dedup saves a step: one row of the work before the
    first read of the context (the time embedding, the stem, the first
    ResBlock, the first SpatialTransformer's proj_in and self-attention)."""
    m = flops.meta
    mc = cfg["unet"]["model_channels"]
    first = unet.input_blocks[1]
    block = first[1].transformer_blocks[0]
    emb = flops.count(lambda: unet.time_embed[2](unet.time_embed[0](m(1, mc))))
    stem = flops.count(lambda: unet.input_blocks[0][0](m(1, cfg["unet"]["in_channels"], h, h)))
    res = flops.count(lambda: first[0](m(1, mc, h, h), m(1, 4 * mc)))
    pin = flops.count(lambda: first[1].proj_in(m(1, mc, h, h)))
    attn = flops.count(lambda: block.attn1(m(1, h * h, mc)))
    return emb + stem + res + pin + attn


def attention_calls_per_batch(cfg: dict, batch: int):
    """[(FLOPs, bytes)] of the attention-kernel calls of one batch: the
    VAE's mid-block at encode and decode (one head of the VAE's widest
    channels) and each UNet self-attention of 512 tokens or more (the
    program sends shorter ones through plain products), the first one at
    the half batch under the CFG dedup."""
    h, u = cfg["latent_size"], cfg["unet"]
    vae_d = cfg["vae"]["ch"] * cfg["vae"]["ch_mult"][-1]
    calls = [flops.attention_call(batch, h * h, h * h, vae_d, "fwd")] * 2
    rows = 2 * batch
    for step in range(cfg["ddim_steps"]):
        for j, (n, d) in enumerate(flops.unet_self_attention_layers(u, h)):
            if n >= 512:
                r = batch if (j == 0 and cfg["cfg_dedup"]) else rows
                calls.append(flops.attention_call(r * u["num_heads"], n, n, d, "fwd"))
    return calls


def flops_per_unit(cfg: dict, traffic: dict) -> float:
    return flops_per_pair(cfg)


def profiled_attention_calls(state: State):
    return attention_calls_per_batch(state.cfg, state.traffic["batch"])
