"""The training step (port of reface_tpu/pipelines/train.py): the eps-MSE
step (recon=None, what cli/train.py runs by default) and the full-loss step
(recon=ReconLossConfig(), --full-losses: eps-MSE plus a k-step DDIM
reconstruction with ID and LPIPS losses, diffusion/losses.py).

Per eps-MSE step, as the JAX package's `loss_fn` (reface_tpu/pipelines/train.py:
214-317): the fused conditioning (trainable mapper and heads over the frozen
CLIP and IR-SE-50 towers), CFG dropout to the learnable null token for
u_cond_percent of the samples, VAE posterior samples of the target and the
masked target under torch.no_grad() (JAX's stop_gradient), the mask resized
to latent size, q_sample at a random timestep, and the MSE between the noise
and the UNet's eps prediction. The optimizer is optax.adamw with the JAX
package's wrapping (make_optimizer), written with torch._foreach_* ops.

Differences of form, not of semantics: the modules hold the parameters
(SwapModules, the UNet and the trainable heads with fp32 weights computed in
bf16, as flax keeps them), the step updates them, the optimizer state and
the EMA in place, and the random draws come from a torch.Generator or from a
`draws` dict (the tests pass JAX's own draws; the two packages' generators
give different numbers). On the card the UNet's self-attention at 4096 and
1024 tokens runs FlashAttention (ops/attention.py: the residual K2 forward,
twice under remat, and K4/K5 in the backward); the VAE encodes run K2.

The full-loss step adds four UNet passes of the reconstruction chain and the
decodes of the collected latents, each through the VAE decoder (built with
VAEConfig.remat: per-block remat, and FlashAttention at d=512 for its
mid-block), the IR-SE-50 ID embedding and LPIPS at three scales. The towers
added for it: "lpips" (frozen) and, when asked for, "landmark_head"
(trained). TrainConfig.split_grad 1 and 2, which on the TPU compile the step
as several programs, here run the recon and the eps portions as separate
backward passes that accumulate into .grad: the same loss, metrics and
gradients, with a lower peak memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from reface_tpu_torch.core.ema import EmaState, ema_update
from reface_tpu_torch.core.schedules import DiffusionSchedule
from reface_tpu_torch.diffusion.losses import (
    ReconLossConfig,
    recon_collect,
    recon_tower_losses,
    reface_losses,
)
from reface_tpu_torch.nn.arcface import ARC_FACE_CROP
from reface_tpu_torch.nn.landmarks import LandmarkAuxHead
from reface_tpu_torch.nn.lpips import LPIPS
from reface_tpu_torch.nn.unet import decoder_feature_shapes
from reface_tpu_torch.nn.vae import SD_SCALE_FACTOR
from reface_tpu_torch.ops.pooling import adaptive_avg_pool2d
from reface_tpu_torch.ops.resize import resize_bilinear_no_aa
from reface_tpu_torch.pipelines.swap import (
    SwapConfig,
    SwapModules,
    clip_normalize,
    init_params,
    resolve_device,
    un_norm,
)

__all__ = ["TrainConfig", "ReconLossConfig", "TrainState", "TrainModules",
           "AdamW", "make_optimizer", "trainable_labels", "named_params", "make_draws",
           "resolve_train_swap_cfg", "make_train_step", "params_with_ema"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig (the same defaults, without
    split_acc_dtype: the gradients accumulate in .grad, in fp32)."""

    learning_rate: float = 1e-5
    warmup_steps: int = 10_000
    weight_decay: float = 1e-2
    u_cond_percent: float = 0.2
    num_timesteps: int = 1000
    grad_clip: Optional[float] = None
    ema_decay: Optional[float] = None  # shipped config: use_ema False
    ema_dtype: Optional[str] = None  # None: the parameters' dtype (fp32)
    accumulate: int = 1  # optax.MultiSteps every_k_schedule
    # the full-loss step in pieces: 0 one backward pass; 1 the recon
    # portion's backward, then the eps portion's; 2 the recon portion cut
    # once more at the collected latents (towers' cotangents, then the
    # chain's pullback). The same loss and gradients at a lower peak memory.
    split_grad: int = 0
    mu_dtype: Optional[str] = None  # AdamW first-moment dtype; None: fp32
    force_unet_remat: bool = True


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the frozen towers: VAE, LPIPS, CLIP ViT-L/14 and IR-SE-50
_FROZEN = ("vae.", "lpips.", "conditioner.cond_stage_model.model.",
           "conditioner.face_ID_model.")


def trainable_labels(params) -> dict[str, str]:
    """name -> "train" / "freeze", the reference's gradient partition over
    the port's state-dict names ("unet.*", "vae.*", "conditioner.*",
    "lpips.*", "landmark_head.*"): everything is trained but the frozen
    towers."""
    return {k: "freeze" if k.startswith(_FROZEN) else "train" for k in params}


class TrainModules(SwapModules):
    """SwapModules with fp32 weights where they are trained, plus the full
    loss's towers: `lpips` (frozen; when lpips is set) and `landmark_head`
    (trained; when landmark_head is set), else None."""

    lpips = landmark_head = None

    def __init__(self, config: SwapConfig, device=None, lpips: bool = False,
                 landmark_head: bool = False):
        super().__init__(config, device, param_dtype=torch.float32)
        if lpips:
            self.lpips = LPIPS(device=self.device).eval().requires_grad_(False)
        if landmark_head:
            # cat(features[9:11]) of the full UNet; clamped for reduced configs
            shapes = decoder_feature_shapes(config.unet, config.latent_size)
            (c0, size), (c1, _) = shapes[min(9, len(shapes) - 2):][:2]
            self.landmark_head = LandmarkAuxHead(c0 + c1, size, device=self.device)
            self.landmark_head.eval().requires_grad_(False)

    def towers(self) -> dict[str, torch.nn.Module]:
        extra = {"lpips": self.lpips, "landmark_head": self.landmark_head}
        return {**super().towers(),
                **{k: m for k, m in extra.items() if m is not None}}


def named_params(modules: SwapModules) -> dict[str, torch.nn.Parameter]:
    """Every parameter of the towers, by "<tower>.<state-dict name>"."""
    return {f"{tower}.{k}": p for tower, m in modules.towers().items()
            for k, p in m.named_parameters()}


# ---------------------------------------------------------------- optimizer

def _linear_schedule(init: float, end: float, steps: int):
    """optax.linear_schedule: init -> end over `steps`, then end (held at
    init when steps <= 0)."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1.0 - min(count, steps) / steps) + end


def _fp32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


class AdamW:
    """optax.adamw(linear warmup, weight_decay, mu_dtype) over the trainable
    parameters, wrapped as the JAX package's make_optimizer wraps it:
    clip_by_global_norm before it (grad_clip), optax.MultiSteps around it
    (accumulate > 1: the running mean of the gradients, one update every
    `accumulate` calls). Frozen parameters are never touched (set_to_zero).

    `step(grads)` updates the parameters and the moments in place; a None
    gradient counts as zeros, as JAX's gradient of an unused leaf is.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: dict[str, torch.Tensor], cfg: TrainConfig):
        labels = trainable_labels(params)
        self.names = [k for k in params if labels[k] == "train"]
        self.params = [params[k] for k in self.names]
        self.lr = _linear_schedule(cfg.learning_rate * 1e-6, cfg.learning_rate,
                                   cfg.warmup_steps)
        self.weight_decay = cfg.weight_decay
        self.grad_clip = cfg.grad_clip
        self.accumulate = cfg.accumulate
        mu_dtype = _DTYPES[cfg.mu_dtype] if cfg.mu_dtype else None
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
            self.acc = ([torch.zeros_like(p) for p in self.params]
                        if cfg.accumulate > 1 else None)
        self.count = 0  # updates applied: Adam's count and the schedule's step
        self.mini_step = 0  # MultiSteps' position inside an accumulation

    @torch.no_grad()
    def step(self, grads) -> bool:
        """One call of the optimizer; returns whether it updated the params."""
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, self.params)]
        if self.acc is not None:
            # MultiSteps (use_grad_mean): acc += (g - acc) / (mini_step + 1)
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step = (self.mini_step + 1) % self.accumulate
            if self.mini_step:
                return False
            grads = self.acc
        if self.grad_clip:
            # clip_by_global_norm: g if |g| < max else (g / |g|) * max
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            clipped = torch._foreach_div(grads, norm)
            torch._foreach_mul_(clipped, float(self.grad_clip))
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        lr = self.lr(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu in fp32, stored in the moment's dtype. With
        # a bf16 moment, optax's weak-typed b1 is rounded to bf16 (0.8984375),
        # as the JAX package's jitted step computes it.
        if self.mu[0].dtype == torch.float32:
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
            mu = self.mu
        else:
            mu = [m.float() for m in self.mu]
            torch._foreach_mul_(mu, float(torch.tensor(b1, dtype=self.mu[0].dtype)))
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        bc1 = 1.0 - _fp32(_fp32(b1) ** self.count)
        bc2 = 1.0 - _fp32(_fp32(b2) ** self.count)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        if mu is not self.mu:
            for m, m32 in zip(self.mu, mu):
                m.copy_(m32)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return True


def make_optimizer(cfg: TrainConfig, params: dict[str, torch.Tensor]) -> AdamW:
    """The JAX package's make_optimizer over name -> parameter."""
    return AdamW(params, cfg)


# ---------------------------------------------------------------- the step

@dataclasses.dataclass
class TrainState:
    modules: SwapModules  # holds the parameters
    opt: AdamW  # holds the optimizer state
    step: int = 0
    ema: Optional[EmaState] = None  # EMA of the UNet's parameters, or None

    @staticmethod
    def create(modules: SwapModules, opt: AdamW, ema_decay=None,
               ema_dtype=None) -> "TrainState":
        ema = None
        if ema_decay is not None:
            ema = EmaState.create(dict(modules.unet.named_parameters()),
                                  decay=ema_decay,
                                  dtype=_DTYPES[ema_dtype] if ema_dtype else None)
        return TrainState(modules, opt, 0, ema)

    def params(self) -> dict:
        """{"unet", "vae", "conditioner"} state dicts (FaceSwapper's params),
        plus "lpips" and "landmark_head" where the trainer holds them."""
        return {name: m.state_dict() for name, m in self.modules.towers().items()}


def resolve_train_swap_cfg(swap_cfg: SwapConfig, train_cfg: TrainConfig,
                           recon) -> SwapConfig:
    """Training-mode overrides of an (inference-defaulted) SwapConfig, as the
    JAX package's: the self-attention goes to the differentiable flash path
    (K1 has no backward), the VAE is rematerialised when the recon loss
    differentiates through its decoder, and the UNet's blocks are
    rematerialised unless force_unet_remat is off."""
    rp = dataclasses.replace
    if swap_cfg.unet.attn_impl in ("auto", "fast"):
        swap_cfg = rp(swap_cfg, unet=rp(swap_cfg.unet, attn_impl="flash"))
    if recon is not None and not swap_cfg.vae.remat:
        swap_cfg = rp(swap_cfg, vae=rp(swap_cfg.vae, remat=True))
    if train_cfg.force_unet_remat and not swap_cfg.unet.remat:
        swap_cfg = rp(swap_cfg, unet=rp(swap_cfg.unet, remat=True))
    return swap_cfg


def make_draws(batch: int, latent: int, cfg: TrainConfig, device,
               generator: torch.Generator | None = None) -> dict:
    """The step's random draws, in the JAX package's layout: t (B,) int,
    noise and the two VAE posterior normals (B, h, w, 4), drop (B,) bool
    (the CFG dropout to the null token)."""
    kw = dict(generator=generator, device=device)
    shape = (batch, latent, latent, 4)
    return {
        "t": torch.randint(0, cfg.num_timesteps, (batch,), **kw),
        "noise": torch.randn(shape, **kw),
        "drop": torch.rand((batch,), **kw) < cfg.u_cond_percent,
        "eps_target": torch.randn(shape, **kw),
        "eps_inpaint": torch.randn(shape, **kw),
    }


def _nchw(x, device):
    return torch.as_tensor(x, device=device).float().permute(0, 3, 1, 2).contiguous()


def make_train_step(swap_cfg: SwapConfig, train_cfg: TrainConfig,
                    recon: ReconLossConfig | None = None, device=None):
    """Returns (train_step, loss_fn, init_state), as the JAX package's.

    recon: a ReconLossConfig turns on the full loss (the k-step DDIM
      reconstruction with ID and LPIPS losses); the trainer then holds an
      "lpips" tower when recon.lpips_weight > 0.
    init_state(params=None, seed=0) -> TrainState: the towers on `device`
      (CUDA unless "cpu" is given), with fp32 weights where they are trained;
      params {"unet", "vae", "conditioner"[, "lpips"][, "landmark_head"]}
      state dicts, or None for a seeded random init (pipelines/swap.py
      init_params, seed + tower index). The landmark auxiliary head is built
      when params holds "landmark_head" or, with params None, when
      recon.landmark_weight > 0.
    loss_fn(modules, batch, draws=None, generator=None, portion="both")
      -> (loss, metrics), differentiable with respect to the trainable
      parameters; portion "eps" / "recon" builds one additive term of the
      full loss.
    train_step(state, batch, draws=None, generator=None) -> (state, metrics):
      one optimizer call (in place) and the EMA. train_step.loss_and_grads(
      modules, batch, draws=None, generator=None) -> (loss, metrics) is its
      first half: it leaves the gradients in the parameters' .grad, in as
      many backward passes as train_cfg.split_grad asks for.
    Batch: NHWC target_image, inpaint_image, inpaint_mask in [-1, 1] / {0,1},
    ref_clip224 (CLIP-normalized), and optionally landmarks (B, 136).
    """
    if train_cfg.split_grad not in (0, 1, 2):
        raise ValueError(f"split_grad must be 0, 1 or 2, got {train_cfg.split_grad!r}")
    swap_cfg = resolve_train_swap_cfg(swap_cfg, train_cfg, recon)
    dev = resolve_device(device)
    schedule = DiffusionSchedule.create(timesteps=train_cfg.num_timesteps).to(dev)
    factor = swap_cfg.image_size // swap_cfg.latent_size
    use_lpips = recon is not None and recon.lpips_weight > 0
    want_lm_head = recon is not None and recon.landmark_weight > 0

    def init_state(params: dict | None = None, seed: int = 0) -> TrainState:
        lm_head = want_lm_head if params is None else "landmark_head" in params
        modules = TrainModules(swap_cfg, dev, lpips=use_lpips, landmark_head=lm_head)
        if params is None:
            for i, m in enumerate(modules.towers().values()):
                init_params(m, seed=seed + i)
        else:
            modules.load_params(params)
        named = named_params(modules)
        for name, label in trainable_labels(named).items():
            named[name].requires_grad_(label == "train")
        return TrainState.create(modules, make_optimizer(train_cfg, named),
                                 ema_decay=train_cfg.ema_decay,
                                 ema_dtype=train_cfg.ema_dtype)

    def posterior_sample(modules, image, eps):
        post = modules.vae.encode(image)
        return (post.mean + post.std * eps) * SD_SCALE_FACTOR

    def prep(modules: TrainModules, batch: dict, draws: dict):
        """The preprocessing every loss portion shares, and the towers'
        closures. Deterministic in (parameters, batch, draws), so each
        split-grad pass rebuilds identical values."""
        target = _nchw(batch["target_image"], dev)
        hw = target.shape[-1] // factor
        ref = _nchw(batch["ref_clip224"], dev)
        lm = batch.get("landmarks")
        lm = None if lm is None else torch.as_tensor(lm, device=dev)
        tar224 = clip_normalize(un_norm(target))
        c = modules.conditioner(ref, tar224, lm)
        uc = modules.conditioner.null_conditioning(c.shape[0])
        # CFG dropout: per-sample swap to the null token
        drop = torch.as_tensor(draws["drop"], device=dev).reshape(-1, 1, 1)
        c = torch.where(drop, uc, c)
        with torch.no_grad():  # the frozen VAE: JAX's stop_gradient
            z = posterior_sample(modules, target, _nchw(draws["eps_target"], dev))
            z_in = posterior_sample(modules, _nchw(batch["inpaint_image"], dev),
                                    _nchw(draws["eps_inpaint"], dev))
        mask = resize_bilinear_no_aa(_nchw(batch["inpaint_mask"], dev), hw, hw)

        def embed_id_fn(img_pm1):
            # the reference's IDLoss.extract_feats: pool to 256, crop, pool to 112
            x = adaptive_avg_pool2d(img_pm1, 256, 256)
            tcrop, bcrop, lcrop, rcrop = ARC_FACE_CROP
            x = adaptive_avg_pool2d(x[:, :, tcrop:bcrop, lcrop:rcrop], 112, 112)
            return modules.conditioner.face_ID_model.facenet(x)

        head = modules.landmark_head
        with_head = want_lm_head and head is not None
        return dict(
            unet_fn=modules.unet,
            decode_fn=modules.decode_latent,
            embed_id_fn=embed_id_fn,
            lpips_fn=modules.lpips if use_lpips else None,
            conditioning_fn=lambda r, l: modules.conditioner(r, tar224, l),
            unet_features_fn=(lambda x9, tt, cc: modules.unet(
                x9, tt, cc, return_features=True)) if with_head else None,
            landmark_head_fn=head if with_head else None,
            z_start9=torch.cat([z, z_in, mask], dim=1),
            cond=c,
            ref_clip224=ref,
            gt_image=target,
            landmarks=lm,
            t=torch.as_tensor(draws["t"], device=dev).long(),
            noise=_nchw(draws["noise"], dev),
        )

    def resolve_draws(batch, draws, generator):
        if draws is not None:
            return draws
        b, size = batch["target_image"].shape[:2]
        return make_draws(b, size // factor, train_cfg, dev, generator)

    def loss_fn(modules: TrainModules, batch: dict, draws: dict | None = None,
                generator: torch.Generator | None = None, portion: str = "both"):
        p = prep(modules, batch, resolve_draws(batch, draws, generator))
        if recon is None:
            z9, t, noise = p["z_start9"], p["t"], p["noise"]
            z_t = schedule.q_sample(z9[:, :4], t, noise)
            eps = p["unet_fn"](torch.cat([z_t, z9[:, 4:]], dim=1), t, p["cond"])
            loss = torch.mean((noise - eps) ** 2)
            return loss, {"loss_simple": loss.detach()}
        loss, metrics = reface_losses(schedule=schedule, cfg=recon, portion=portion, **p)
        return loss, {k: v.detach() for k, v in metrics.items()}

    split = (train_cfg.split_grad if recon is not None
             and (recon.id_weight > 0 or recon.lpips_weight > 0) else 0)

    def recon_backward_by_stages(modules, batch, draws):
        """split_grad=2: the recon portion cut at the collected latents,
        which carry every trainable parameter's influence on it (the towers
        are frozen). The chain's forward keeps its graph; the towers'
        backward gives the cotangents of the latents; the chain's backward
        pulls them back to the parameters."""
        p = prep(modules, batch, draws)
        pred_latents, ref_flip = recon_collect(
            unet_fn=p["unet_fn"], conditioning_fn=p["conditioning_fn"],
            schedule=schedule, cfg=recon, z_start9=p["z_start9"], cond=p["cond"],
            ref_clip224=p["ref_clip224"], landmarks=p["landmarks"], t=p["t"],
            noise=p["noise"])
        leaves = [x.detach().requires_grad_(x.requires_grad) for x in pred_latents]
        loss_r, metrics_r = recon_tower_losses(
            decode_fn=p["decode_fn"], embed_id_fn=p["embed_id_fn"],
            lpips_fn=p["lpips_fn"], cfg=recon, pred_latents=leaves,
            ref_flip=ref_flip, rest=p["z_start9"][:, 4:], gt_image=p["gt_image"])
        loss_r.backward()
        pairs = [(x, leaf.grad) for x, leaf in zip(pred_latents, leaves)
                 if leaf.grad is not None]
        torch.autograd.backward([x for x, _ in pairs], [g for _, g in pairs])
        return loss_r.detach(), {k: v.detach() for k, v in metrics_r.items()}

    def loss_and_grads(modules: TrainModules, batch: dict, draws: dict | None = None,
                       generator: torch.Generator | None = None):
        """(loss, metrics) with the gradients left in the parameters' .grad
        (set to None first). split_grad > 0: the recon portion's backward,
        then the eps portion's, accumulating; the same draws in both."""
        for prm in named_params(modules).values():
            prm.grad = None
        draws = resolve_draws(batch, draws, generator)
        if not split:
            loss, metrics = loss_fn(modules, batch, draws)
            loss.backward()
            return loss.detach(), metrics
        if split == 1:
            loss_r, metrics_r = loss_fn(modules, batch, draws, portion="recon")
            loss_r.backward()
            loss_r = loss_r.detach()
        else:
            loss_r, metrics_r = recon_backward_by_stages(modules, batch, draws)
        loss_e, metrics_e = loss_fn(modules, batch, draws, portion="eps")
        loss_e.backward()
        # the recon portion's "loss" is its own total; the step's is the sum
        loss = loss_e.detach() + loss_r
        return loss, {**metrics_r, **metrics_e, "loss": loss}

    def train_step(state: TrainState, batch: dict, draws: dict | None = None,
                   generator: torch.Generator | None = None):
        loss, metrics = loss_and_grads(state.modules, batch, draws, generator)
        state.opt.step([p.grad for p in state.opt.params])
        if state.ema is not None:
            ema_update(state.ema, dict(state.modules.unet.named_parameters()))
        state.step += 1
        return state, {**metrics, "loss": loss}

    train_step.loss_and_grads = loss_and_grads
    return train_step, loss_fn, init_state


def params_with_ema(params: dict, state: TrainState) -> dict:
    """ema_scope parity: {"unet", "vae", "conditioner"} state dicts with the
    UNet's swapped for its EMA shadow; unchanged when EMA is off."""
    if state.ema is None:
        return params
    return {**params, "unet": dict(state.ema.shadow)}
