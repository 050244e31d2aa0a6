"""The eps-MSE training step (port of reface_tpu/pipelines/train.py with
recon=None, the step cli/train.py runs unless --full-losses is given).

Per step, as the JAX package's `loss_fn` (reface_tpu/pipelines/train.py:
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

The full-loss step (recon, LPIPS, the ID loss, split_grad) is not ported
yet (ROADMAP A12b).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from reface_tpu_torch.core.ema import EmaState, ema_update
from reface_tpu_torch.core.schedules import DiffusionSchedule
from reface_tpu_torch.nn.vae import SD_SCALE_FACTOR
from reface_tpu_torch.ops.resize import resize_bilinear_no_aa
from reface_tpu_torch.pipelines.swap import (
    SwapConfig,
    SwapModules,
    init_params,
    resolve_device,
)

__all__ = ["TrainConfig", "TrainState", "AdamW", "make_optimizer",
           "trainable_labels", "named_params", "make_draws",
           "resolve_train_swap_cfg", "make_train_step", "params_with_ema"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig (the same defaults; split_grad's
    accumulator dtype goes with split_grad, ROADMAP A12b)."""

    learning_rate: float = 1e-5
    warmup_steps: int = 10_000
    weight_decay: float = 1e-2
    u_cond_percent: float = 0.2
    num_timesteps: int = 1000
    grad_clip: Optional[float] = None
    ema_decay: Optional[float] = None  # shipped config: use_ema False
    ema_dtype: Optional[str] = None  # None: the parameters' dtype (fp32)
    accumulate: int = 1  # optax.MultiSteps every_k_schedule
    # the TPU's multi-program split of the full-loss step: not ported (A12b)
    split_grad: int = 0
    mu_dtype: Optional[str] = None  # AdamW first-moment dtype; None: fp32
    force_unet_remat: bool = True


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the frozen towers: VAE, CLIP ViT-L/14 and IR-SE-50 (and LPIPS, once ported)
_FROZEN = ("vae.", "lpips.", "conditioner.cond_stage_model.model.",
           "conditioner.face_ID_model.")


def trainable_labels(params) -> dict[str, str]:
    """name -> "train" / "freeze", the reference's gradient partition over
    the port's state-dict names ("unet.*", "vae.*", "conditioner.*"):
    everything is trained but the frozen towers."""
    return {k: "freeze" if k.startswith(_FROZEN) else "train" for k in params}


def named_params(modules: SwapModules) -> dict[str, torch.nn.Parameter]:
    """Every parameter of the three towers, by "<tower>.<state-dict name>"."""
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
        """{"unet", "vae", "conditioner"} state dicts (FaceSwapper's params)."""
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


def make_train_step(swap_cfg: SwapConfig, train_cfg: TrainConfig, recon=None,
                    device=None):
    """Returns (train_step, loss_fn, init_state), as the JAX package's.

    init_state(params=None, seed=0) -> TrainState: the towers on `device`
      (CUDA unless "cpu" is given), with fp32 weights where they are trained;
      params {"unet", "vae", "conditioner"} state dicts, or None for a seeded
      random init (pipelines/swap.py init_params, seed + tower index).
    loss_fn(modules, batch, draws=None, generator=None) -> (loss, metrics),
      differentiable with respect to the trainable parameters.
    train_step(state, batch, draws=None, generator=None) -> (state, metrics):
      one optimizer call (in place) and the EMA.
    Batch: NHWC target_image, inpaint_image, inpaint_mask in [-1, 1] / {0,1},
    ref_clip224 (CLIP-normalized), and optionally landmarks (B, 136).
    """
    if recon is not None:
        raise NotImplementedError("the full-loss training step (recon) is not "
                                  "ported yet (ROADMAP A12b)")
    if train_cfg.split_grad:
        raise NotImplementedError("split_grad is not ported yet (ROADMAP A12b)")
    swap_cfg = resolve_train_swap_cfg(swap_cfg, train_cfg, recon)
    dev = resolve_device(device)
    schedule = DiffusionSchedule.create(timesteps=train_cfg.num_timesteps)
    sqrt_acp = schedule.sqrt_alphas_cumprod.to(dev)
    sqrt_1m_acp = schedule.sqrt_one_minus_alphas_cumprod.to(dev)
    factor = swap_cfg.image_size // swap_cfg.latent_size

    def init_state(params: dict | None = None, seed: int = 0) -> TrainState:
        modules = SwapModules(swap_cfg, dev, param_dtype=torch.float32)
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

    def loss_fn(modules: SwapModules, batch: dict, draws: dict | None = None,
                generator: torch.Generator | None = None):
        target = _nchw(batch["target_image"], dev)
        b, hw = target.shape[0], target.shape[-1] // factor
        if draws is None:
            draws = make_draws(b, hw, train_cfg, dev, generator)
        lm = batch.get("landmarks")
        c, uc = modules.build_context(_nchw(batch["ref_clip224"], dev), target,
                                      None if lm is None else torch.as_tensor(lm, device=dev))
        drop = torch.as_tensor(draws["drop"], device=dev).reshape(-1, 1, 1)
        c = torch.where(drop, uc, c)
        with torch.no_grad():  # the frozen VAE: JAX's stop_gradient
            z = posterior_sample(modules, target, _nchw(draws["eps_target"], dev))
            z_in = posterior_sample(modules, _nchw(batch["inpaint_image"], dev),
                                    _nchw(draws["eps_inpaint"], dev))
        mask = resize_bilinear_no_aa(_nchw(batch["inpaint_mask"], dev), hw, hw)
        t = torch.as_tensor(draws["t"], device=dev).long()
        noise = _nchw(draws["noise"], dev)
        z_t = sqrt_acp[t][:, None, None, None] * z + sqrt_1m_acp[t][:, None, None, None] * noise
        eps = modules.unet(torch.cat([z_t, z_in, mask], dim=1), t, c)
        loss = torch.mean((noise - eps) ** 2)
        return loss, {"loss_simple": loss.detach()}

    def train_step(state: TrainState, batch: dict, draws: dict | None = None,
                   generator: torch.Generator | None = None):
        for p in state.opt.params:
            p.grad = None
        loss, metrics = loss_fn(state.modules, batch, draws, generator)
        loss.backward()
        state.opt.step([p.grad for p in state.opt.params])
        if state.ema is not None:
            ema_update(state.ema, dict(state.modules.unet.named_parameters()))
        state.step += 1
        return state, {**metrics, "loss": loss.detach()}

    return train_step, loss_fn, init_state


def params_with_ema(params: dict, state: TrainState) -> dict:
    """ema_scope parity: {"unet", "vae", "conditioner"} state dicts with the
    UNet's swapped for its EMA shadow; unchanged when EMA is off."""
    if state.ema is None:
        return params
    return {**params, "unet": dict(state.ema.shadow)}
