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
gradients, with a lower peak memory. TrainConfig.split_acc_dtype "bfloat16"
rounds the recon portion's gradient to bf16 before the sum, as the JAX step
does; it saves no memory here.

With a mesh (parallel/mesh.py, make_train_step(mesh=...)) the step computes
what the JAX step computes on the global batch under GSPMD: each rank holds
its data slice of the batch, every rank draws the global batch's draws from
the same generator state and takes its slice, the full loss's flipped
reference is the global batch's flip (a rank's rows take the mirror data
rank's references), the trainable gradients and
the metrics are averaged over the data group after the backward (in flat
buckets of GRAD_BUCKET elements), and the UNet runs tensor-parallel over the
model group (parallel/tp.py) when the mesh has one; the gradient clip then
takes the norm of the whole parameters.

While a profiler runs, `train_step` records the spans of core/profiling.py:
`train.step` holds `train.forward` (itself holding `train.prep` and, in
diffusion/losses.py, `train.eps`, `train.recon` and `train.towers`),
`train.backward` (each backward pass, split_grad's included) and
`train.update` (AdamW and the EMA). The split steps' forwards and backwards
reuse the names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch

from reface_tpu_torch.core.ema import EmaState, ema_update
from reface_tpu_torch.core.profiling import span
from reface_tpu_torch.core.schedules import DiffusionSchedule
from reface_tpu_torch.diffusion.losses import (
    ReconLossConfig,
    recon_collect,
    recon_tower_losses,
    reface_losses,
)
from reface_tpu_torch.nn.landmarks import LandmarkAuxHead
from reface_tpu_torch.nn.lpips import LPIPS
from reface_tpu_torch.nn.unet import decoder_feature_shapes
from reface_tpu_torch.nn.vae import SD_SCALE_FACTOR
from reface_tpu_torch.ops.resize import resize_bilinear_no_aa
from reface_tpu_torch.parallel.mesh import all_gather, all_reduce, shard_params
from reface_tpu_torch.pipelines.swap import (
    SwapConfig,
    SwapModules,
    clip_normalize,
    init_params,
    resolve_device,
    un_norm,
)

__all__ = ["TrainConfig", "ReconLossConfig", "TrainState", "TrainModules",
           "AdamW", "make_optimizer", "cosine_decay_schedule", "trainable_labels", "named_params", "make_draws",
           "resolve_train_swap_cfg", "make_train_step", "params_with_ema",
           "average_grads"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig, with the same defaults."""

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
    # the dtype the recon portion's gradient is held in until it is added to
    # the eps portion's (split_grad 1 and 2): "float32" is exact; "bfloat16"
    # rounds that contribution to bf16 before the sum, as the JAX step does
    # (at split_grad 2 its pullback is taken with respect to the trainable
    # parameters in bf16, the JAX step's pre-cast copy). On the TPU it shrinks
    # the accumulator tree that the eps program is given; here the eps
    # portion's backward accumulates onto the recon portion's .grad in place,
    # so there is no such tree: "bfloat16" changes the rounding only, and at
    # split_grad 2 runs the chain's forward once more.
    split_acc_dtype: str = "float32"
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


def cosine_decay_schedule(init: float, decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule: init * ((1 - alpha) * (1 + cos(pi * c / n))
    / 2 + alpha) at c = min(count, n), in fp32 as optax computes it."""
    def lr(count):
        c = torch.tensor(min(count, decay_steps), dtype=torch.float32)
        cos = 0.5 * (1.0 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * c
                                     / decay_steps))
        return float(init * ((1.0 - alpha) * cos + alpha))
    return lr


class AdamW:
    """optax's Adam family over the parameters it is given, written with
    torch._foreach_* ops: scale_by_adam(b1, b2, eps, mu_dtype), then
    add_decayed_weights(weight_decay) (0: plain optax.adam), then the learning
    rate `lr` (a float, or a schedule of the update count), optionally
    behind clip_by_global_norm (grad_clip) and inside optax.MultiSteps
    (accumulate > 1: the running mean of the gradients, one update every
    `accumulate` calls). Under tensor parallelism (`model_group`, the
    parameters that parallel/tp.py sharded marked by their `tp_dim`) the
    clip's norm is the whole parameters': the squares of the sharded leaves
    summed over the model group, the replicated ones counted once. The
    trainers build it through make_optimizer (the
    JAX package's adamw with warmup over the trainable parameters),
    cli/distill.py (adam at a constant rate), diffusion/vae_loss.py (adam,
    b1 = 0.5, b2 = 0.9) and cli/train_landmarks.py (adamw under a cosine
    decay).

    `step(grads)` updates the parameters and the moments in place; a None
    gradient counts as zeros, as JAX's gradient of an unused leaf is.
    """

    eps = 1e-8

    def __init__(self, params: dict[str, torch.Tensor], lr, b1: float = 0.9,
                 b2: float = 0.999, weight_decay: float = 0.0,
                 grad_clip: Optional[float] = None, accumulate: int = 1,
                 mu_dtype: Optional[str] = None, model_group=None):
        self.names = list(params)
        self.model_group = model_group
        self.params = [params[k] for k in self.names]
        self.lr = lr if callable(lr) else (lambda count: lr)
        self.b1, self.b2 = b1, b2
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.accumulate = accumulate
        mu_dtype = _DTYPES[mu_dtype] if mu_dtype else None
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
            self.acc = ([torch.zeros_like(p) for p in self.params]
                        if accumulate > 1 else None)
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
            norm = self._global_norm(grads)
            clipped = torch._foreach_div(grads, norm)
            torch._foreach_mul_(clipped, float(self.grad_clip))
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        lr = self.lr(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu in fp32, stored in the moment's dtype. With
        # a bf16 moment, optax's weak-typed b1 is rounded to bf16 (0.9 ->
        # 0.8984375), as the JAX package's jitted step computes it.
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
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        if mu is not self.mu:
            for m, m32 in zip(self.mu, mu):
                m.copy_(m32)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return True

    def _global_norm(self, grads) -> torch.Tensor:
        norms = torch.stack(torch._foreach_norm(grads))
        if self.model_group is None:
            return torch.linalg.vector_norm(norms)
        sharded = torch.tensor([getattr(p, "tp_dim", None) is not None for p in self.params],
                               device=norms.device)
        sq = norms.float() ** 2
        parts = torch.stack([sq[sharded].sum(), sq[~sharded].sum()])
        all_reduce(parts[:1], self.model_group)  # a view: reduced in place
        return parts.sum().sqrt()


def make_optimizer(cfg: TrainConfig, params: dict[str, torch.Tensor],
                   model_group=None) -> AdamW:
    """The JAX package's make_optimizer over name -> parameter: optax.adamw
    with a linear warmup over the trainable parameters (frozen ones are
    never touched: set_to_zero), clipping and MultiSteps as configured;
    model_group: the mesh's, when the UNet is tensor-parallel."""
    labels = trainable_labels(params)
    return AdamW({k: p for k, p in params.items() if labels[k] == "train"},
                 lr=_linear_schedule(cfg.learning_rate * 1e-6, cfg.learning_rate,
                                     cfg.warmup_steps),
                 weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip,
                 accumulate=cfg.accumulate, mu_dtype=cfg.mu_dtype,
                 model_group=model_group)


# the elements of one flat bucket of the data-parallel gradient all-reduce
GRAD_BUCKET = 1 << 24


@torch.no_grad()
def average_grads(params, group, n: int) -> None:
    """Each parameter's .grad replaced by its mean over `group` (n ranks),
    in flat buckets of at most GRAD_BUCKET elements of one dtype (one tensor
    above it alone); nothing without a group. Every rank must hold .grad on
    the same parameters, as the same graph on each rank gives."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    i = 0
    while i < len(grads):
        j, size = i + 1, grads[i].numel()
        while (j < len(grads) and grads[j].dtype == grads[i].dtype
               and size + grads[j].numel() <= GRAD_BUCKET):
            size += grads[j].numel()
            j += 1
        flat = torch.cat([g.reshape(-1) for g in grads[i:j]])
        all_reduce(flat, group).div_(n)
        at = 0
        for g in grads[i:j]:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        i = j


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
                    recon: ReconLossConfig | None = None, device=None, mesh=None):
    """Returns (train_step, loss_fn, init_state), as the JAX package's.

    mesh: a parallel.mesh.Mesh. The batch each rank passes is its data slice
      of the global batch (B_local rows), `draws` (where given) are the
      global batch's, and the step is the global batch's (module docstring).
      init_state broadcasts the towers from data index 0 (shard_params) and,
      on a model axis, shards the UNet (parallel/tp.py shard_params_tp;
      TrainState.params() then holds its local shards, gather_params_tp the
      whole). device defaults to the mesh's.

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
      many backward passes as train_cfg.split_grad asks for (with a mesh,
      the data group's mean). At split_grad 1 and 2 (these two taking the
      draws of this rank's rows), train_step.recon_backward(modules, batch, draws) ->
      (loss_r, metrics_r) is the recon portion's backward that the eps
      portion's adds onto, and train_step.recon_cotangents(modules, batch,
      draws) split_grad=2's first stage (the towers' cotangents of the
      chain's latents).
    Batch: NHWC target_image, inpaint_image, inpaint_mask in [-1, 1] / {0,1},
    ref_clip224 (CLIP-normalized), and optionally landmarks (B, 136).
    """
    if train_cfg.split_grad not in (0, 1, 2):
        raise ValueError(f"split_grad must be 0, 1 or 2, got {train_cfg.split_grad!r}")
    if train_cfg.split_acc_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"split_acc_dtype must be 'float32' or 'bfloat16', "
                         f"got {train_cfg.split_acc_dtype!r}")
    swap_cfg = resolve_train_swap_cfg(swap_cfg, train_cfg, recon)
    dev = resolve_device(device if device is not None or mesh is None else mesh.device)
    data_group = None if mesh is None else mesh.data_group
    n_data = 1 if mesh is None else mesh.n_data
    model_group = None if mesh is None or mesh.n_model == 1 else mesh.model_group
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
        if mesh is not None:
            shard_params(modules, mesh)
            if mesh.n_model > 1:
                from reface_tpu_torch.parallel.tp import shard_params_tp

                shard_params_tp(modules, mesh)
        named = named_params(modules)
        for name, label in trainable_labels(named).items():
            named[name].requires_grad_(label == "train")
        return TrainState.create(modules, make_optimizer(train_cfg, named, model_group),
                                 ema_decay=train_cfg.ema_decay,
                                 ema_dtype=train_cfg.ema_dtype)

    def posterior_sample(modules, image, eps):
        post = modules.vae.encode(image)
        return (post.mean + post.std * eps) * SD_SCALE_FACTOR

    def prep(modules: TrainModules, batch: dict, draws: dict):
        """The preprocessing every loss portion shares, and the towers'
        closures. Deterministic in (parameters, batch, draws), so each
        split-grad pass rebuilds identical values."""
        with span("train.prep"):
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

        head = modules.landmark_head
        with_head = want_lm_head and head is not None
        return dict(
            unet_fn=modules.unet,
            decode_fn=modules.decode_latent,
            embed_id_fn=modules.embed_id,  # the reference's IDLoss.extract_feats
            lpips_fn=modules.lpips if use_lpips else None,
            conditioning_fn=lambda r, l: modules.conditioner(r, tar224, l),
            unet_features_fn=(lambda x9, tt, cc: modules.unet(
                x9, tt, cc, return_features=True)) if with_head else None,
            landmark_head_fn=head if with_head else None,
            z_start9=torch.cat([z, z_in, mask], dim=1),
            cond=c,
            ref_clip224=flip_source(ref),
            gt_image=target,
            landmarks=lm,
            t=torch.as_tensor(draws["t"], device=dev).long(),
            noise=_nchw(draws["noise"], dev),
        )

    def flip_source(ref):
        """The rows whose flip(0) the recon chain takes as its reference.
        The JAX step flips the global batch (ReconLossConfig.flip_reference),
        so a rank's rows take theirs from the mirror data rank's rows."""
        if n_data == 1 or recon is None or not recon.flip_reference:
            return ref
        b = ref.shape[0]
        mirror = n_data - 1 - mesh.data_rank
        return all_gather(ref, data_group, 0)[mirror * b:(mirror + 1) * b]

    def resolve_draws(batch, draws, generator):
        """The draws of this rank's rows: with a mesh, the global batch's
        draws (made, or given) sliced at the rank's data index."""
        b, size = batch["target_image"].shape[:2]
        if draws is None:
            draws = make_draws(b * n_data, size // factor, train_cfg, dev, generator)
        if mesh is None:
            return draws
        if len(draws["t"]) != b * n_data:
            raise ValueError(f"draws for {len(draws['t'])} rows; the mesh's global "
                             f"batch is {b} x {n_data}")
        lo = mesh.data_rank * b
        return {k: v[lo:lo + b] for k, v in draws.items()}

    def sync(modules) -> None:
        average_grads(named_params(modules).values(), data_group, n_data)

    def loss_fn(modules: TrainModules, batch: dict, draws: dict | None = None,
                generator: torch.Generator | None = None, portion: str = "both"):
        return local_loss(modules, batch, resolve_draws(batch, draws, generator), portion)

    def local_loss(modules, batch, draws, portion="both"):
        """loss_fn on this rank's rows with their draws."""
        with span("train.forward"):
            p = prep(modules, batch, draws)
            if recon is None:
                with span("train.eps"):
                    z9, t, noise = p["z_start9"], p["t"], p["noise"]
                    z_t = schedule.q_sample(z9[:, :4], t, noise)
                    eps = p["unet_fn"](torch.cat([z_t, z9[:, 4:]], dim=1), t, p["cond"])
                    loss = torch.mean((noise - eps) ** 2)
                return loss, {"loss_simple": loss.detach()}
            loss, metrics = reface_losses(schedule=schedule, cfg=recon, portion=portion, **p)
            return loss, {k: v.detach() for k, v in metrics.items()}

    split = (train_cfg.split_grad if recon is not None
             and (recon.id_weight > 0 or recon.lpips_weight > 0) else 0)

    acc_bf16 = train_cfg.split_acc_dtype == "bfloat16"

    def collect(modules, batch, draws):
        """(prep's values, the collected latents, ref_flip) of the recon
        chain's forward, with its graph."""
        p = prep(modules, batch, draws)
        pred_latents, ref_flip = recon_collect(
            unet_fn=p["unet_fn"], conditioning_fn=p["conditioning_fn"],
            schedule=schedule, cfg=recon, z_start9=p["z_start9"], cond=p["cond"],
            ref_clip224=p["ref_clip224"], landmarks=p["landmarks"], t=p["t"],
            noise=p["noise"])
        return p, pred_latents, ref_flip

    def recon_cotangents(modules, batch, draws):
        """split_grad=2's first half: (loss_r, metrics_r, the collected
        latents with the chain's graph, [(i, cotangent)]): the towers'
        backward gives the cotangent of each latent i that depends on a
        trainable parameter."""
        with span("train.forward"):
            p, pred_latents, ref_flip = collect(modules, batch, draws)
            leaves = [x.detach().requires_grad_(x.requires_grad) for x in pred_latents]
            loss_r, metrics_r = recon_tower_losses(
                decode_fn=p["decode_fn"], embed_id_fn=p["embed_id_fn"],
                lpips_fn=p["lpips_fn"], cfg=recon, pred_latents=leaves,
                ref_flip=ref_flip, rest=p["z_start9"][:, 4:], gt_image=p["gt_image"])
        with span("train.backward"):
            loss_r.backward()
        cots = [(i, leaf.grad) for i, leaf in enumerate(leaves) if leaf.grad is not None]
        return (loss_r.detach(), {k: v.detach() for k, v in metrics_r.items()},
                pred_latents, cots)

    def pullback(pred_latents, cots) -> None:
        with span("train.backward"):
            torch.autograd.backward([pred_latents[i] for i, _ in cots], [g for _, g in cots])

    def recon_backward(modules, batch, draws):
        """The recon portion's backward of a split step, its gradients left
        in .grad. split_grad=2 cuts it at the collected latents, which carry
        every trainable parameter's influence on it (the towers are frozen):
        the chain's forward keeps its graph, the towers' backward gives the
        cotangents of the latents, the chain's backward pulls them back to
        the parameters. With the bf16 accumulator the gradients are left in
        .grad rounded to bf16, as the JAX step holds them: at split_grad=1
        rounded once at the end; at split_grad=2 pulled back with respect to
        the trainable parameters in bf16 (_bf16_leaves), so that each use's
        contribution is rounded and the sum over the chain's steps is carried
        in bf16, as JAX's pre-cast bf16 tree carries it. That pullback runs
        the chain's forward again at the bf16 weights, as JAX's does."""
        if split == 1:
            loss_r, metrics_r = local_loss(modules, batch, draws, portion="recon")
            with span("train.backward"):
                loss_r.backward()
            if acc_bf16:
                sync(modules)  # the global recon gradient is the one rounded
                with torch.no_grad():
                    for prm in named_params(modules).values():
                        if prm.grad is not None:
                            prm.grad = prm.grad.to(torch.bfloat16).float()
            return loss_r.detach(), metrics_r
        loss_r, metrics_r, pred_latents, cots = recon_cotangents(modules, batch, draws)
        if acc_bf16:
            del pred_latents
            with _bf16_leaves(modules):
                with span("train.forward"):
                    pred_latents = collect(modules, batch, draws)[1]
                pullback(pred_latents, cots)
            if data_group is not None:
                # the mean of the ranks' bf16 sums, rounded once more
                sync(modules)
                with torch.no_grad():
                    for prm in named_params(modules).values():
                        if prm.grad is not None:
                            prm.grad = prm.grad.to(torch.bfloat16).float()
        else:
            pullback(pred_latents, cots)
        return loss_r, metrics_r

    def loss_and_grads(modules: TrainModules, batch: dict, draws: dict | None = None,
                       generator: torch.Generator | None = None):
        """(loss, metrics) with the gradients left in the parameters' .grad
        (set to None first). split_grad > 0: the recon portion's backward
        (recon_backward), then the eps portion's accumulating onto it; the
        same draws in both. With a mesh, the gradients and the metrics are
        the data group's means: the global batch's. With the bf16
        accumulator the recon portion is averaged before its rounding; the
        eps portion then adds onto that common value on every rank, and the
        second average gives it plus the eps portion's mean."""
        for prm in named_params(modules).values():
            prm.grad = None
        draws = resolve_draws(batch, draws, generator)
        if not split:
            loss, metrics = local_loss(modules, batch, draws)
            with span("train.backward"):
                loss.backward()
            loss = loss.detach()
        else:
            loss_r, metrics_r = recon_backward(modules, batch, draws)
            loss_e, metrics_e = local_loss(modules, batch, draws, portion="eps")
            with span("train.backward"):
                loss_e.backward()
            # the recon portion's "loss" is its own total; the step's is the sum
            loss = loss_e.detach() + loss_r
            metrics = {**metrics_r, **metrics_e, "loss": loss}
        if mesh is None:
            return loss, metrics
        sync(modules)
        names = sorted(metrics)
        vals = torch.stack([loss.float()] + [metrics[k].float() for k in names])
        all_reduce(vals, data_group).div_(n_data)
        return vals[0], {k: vals[i + 1] for i, k in enumerate(names)}

    def train_step(state: TrainState, batch: dict, draws: dict | None = None,
                   generator: torch.Generator | None = None):
        with span("train.step"):
            loss, metrics = loss_and_grads(state.modules, batch, draws, generator)
            with span("train.update"):
                state.opt.step([p.grad for p in state.opt.params])
                if state.ema is not None:
                    ema_update(state.ema, dict(state.modules.unet.named_parameters()))
        state.step += 1
        return state, {**metrics, "loss": loss}

    train_step.loss_and_grads = loss_and_grads
    train_step.recon_backward = recon_backward
    train_step.recon_cotangents = recon_cotangents
    return train_step, loss_fn, init_state


@contextlib.contextmanager
def _bf16_leaves(modules: SwapModules):
    """Each trainable parameter's data swapped for a bf16 copy of itself
    (the fp32 tensor kept aside, not copied), so that a backward run inside
    fills bf16 .grad. On exit the fp32 data comes back and each gradient is
    widened to fp32 in place of its bf16 one."""
    trainable = [q for q in named_params(modules).values() if q.requires_grad]
    kept = [q.data for q in trainable]
    for q in trainable:
        q.data = q.data.to(torch.bfloat16)
    try:
        yield
    finally:
        for q, data in zip(trainable, kept):
            g, q.grad = q.grad, None
            q.data = data
            q.grad = None if g is None else g.float()


def params_with_ema(params: dict, state: TrainState) -> dict:
    """ema_scope parity: {"unet", "vae", "conditioner"} state dicts with the
    UNet's swapped for its EMA shadow; unchanged when EMA is off."""
    if state.ema is None:
        return params
    return {**params, "unet": dict(state.ema.shadow)}
