"""REFace's full training step in plain fp32: the reference the training
cells are judged by.

The loss, as configs/train.yaml trains with it (the reference's
ddpm.py p_losses with Reconstruct_initial and the ID and LPIPS losses):

  1. the conditioning of each row, swapped for the learnable null token
     where the row's CFG-drop draw says so;
  2. the VAE posterior samples of the target and the masked target (the VAE
     is frozen), the mask at latent size;
  3. eps-MSE: the UNet's eps at the row's timestep t against the noise;
  4. the reconstruction: the same noise at t = T-1, then k DDIM steps
     (model timesteps flip(range(1, T-2, (T-2)//k)[:k]), the scalars of
     the k-step DDIM tables) conditioned on the flipped batch's source;
     the noisy latent, the first step's and the last step's x0 decoded,
     clamped to [-1, 1];
  5. ID: 1 - cos between IR-SE-50 of each decode (inpaint region only) and
     of the flipped source, averaged over the decodes; LPIPS of each decode
     against the target at each scale, summed;
  total = eps-MSE + id_weight ID + lpips_weight LPIPS, every term a mean
  over the batch's rows. The optimizer is AdamW (optax's adamw) over every
  tower but the VAE, LPIPS, CLIP's vision tower and IR-SE-50.

Rows are computed in blocks (`block` rows at a time), each block's loss
scaled by its share of the batch and its gradients summed: the values of
the whole batch's step. The UNet's blocks, the decoder's blocks and each
decode's towers are recomputed in the backward, as the measured program
does, so that the model FLOPs counted over this module are the program's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gpubench.reference import nets

FROZEN = ("vae.", "lpips.", "conditioner.cond_stage_model.model.", "conditioner.face_ID_model.")


class TrainReference(torch.nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.unet = nets.UNet(cfg["unet"], remat=True)
        self.vae = nets.AutoencoderKL(cfg["vae"], remat=True)
        self.conditioner = nets.Conditioner(cfg)
        self.lpips = nets.LPIPS()

    def trainable(self) -> dict:
        return {k: p for k, p in self.named_parameters() if not k.startswith(FROZEN)}

    def freeze(self):
        for k, p in self.named_parameters():
            p.requires_grad_(not k.startswith(FROZEN))
        return self


def _q_sample(acp, z, t, noise):
    a = acp[t].reshape(-1, 1, 1, 1)
    return torch.sqrt(a) * z + torch.sqrt(1.0 - a) * noise


def recon_schedule(k: int, n: int = 1000):
    """(model timesteps, a_t, a_prev) of the k reconstruction steps."""
    t_new = n - 1
    seq = list(range(1, t_new - 1, max(1, (t_new - 1) // k)))[:k][::-1]
    _, a, a_prev = nets.ddim_tables(len(seq), n)
    return seq, a, a_prev


def loss(ref: TrainReference, rows: dict, flip_ref, draws: dict, total_rows: int):
    """The loss of a block of rows, scaled by rows / total_rows (so that the
    blocks' losses and gradients sum to the batch's). rows: NCHW target,
    inpaint, mask, ref_clip224, landmarks; flip_ref: the CLIP crops of the
    rows' flipped partners; draws: t, noise, drop, eps_target, eps_inpaint
    (the latents NCHW)."""
    cfg, rc = ref.cfg, ref.cfg["recon"]
    dev = rows["target"].device
    acp = torch.tensor(nets.alphas_cumprod(), dtype=torch.float32, device=dev)
    target, lm = rows["target"], rows["landmarks"]
    tar224 = nets.clip_input(target)
    c = ref.conditioner(rows["ref_clip224"], tar224, lm)
    c = torch.where(draws["drop"].reshape(-1, 1, 1), ref.conditioner.learnable_vector.expand_as(c), c)
    with torch.no_grad():
        m, s = ref.vae.posterior(target)
        z = (m + s * draws["eps_target"]) * nets.SD_SCALE_FACTOR
        m, s = ref.vae.posterior(rows["inpaint"])
        z_in = (m + s * draws["eps_inpaint"]) * nets.SD_SCALE_FACTOR
    hw = z.shape[-1]
    mask = F.interpolate(rows["mask"], size=(hw, hw), mode="bilinear", align_corners=False)
    rest = torch.cat([z_in, mask], dim=1)
    t, noise = draws["t"], draws["noise"]
    eps = ref.unet(torch.cat([_q_sample(acp, z, t, noise), rest], dim=1), t, c)
    loss_simple = torch.mean((noise - eps) ** 2)

    seq, a, a_prev = recon_schedule(rc["ddim_steps"])
    x = x_noisy = _q_sample(acp, z, torch.full_like(t, len(acp) - 1), noise)
    c_flip = ref.conditioner(flip_ref, tar224, lm)
    preds = []
    for i, tt in enumerate(seq):
        e = ref.unet(torch.cat([x, rest], dim=1), torch.full_like(t, tt), c_flip)
        x, x0 = nets.ddim_update(x, e, float(a[i]), float(a_prev[i]))
        preds.append(x0)
    latents = [x_noisy, preds[0], preds[-1]]

    size = target.shape[-1]
    region = 1.0 - F.interpolate(mask, size=(size, size), mode="bilinear", align_corners=False)
    with torch.no_grad():
        f_ref = ref.conditioner.face_ID_model.facenet(nets.arcface_input(nets.clip_to_pm1(flip_ref)))
    scales = [f for f in rc["lpips_scales"] if size // f >= 32]
    pool = lambda img, f: img if f == 1 else F.avg_pool2d(img, f)
    gts = [pool(target, f) for f in scales]

    def towers(latent):
        img = ref.vae.decode(latent / nets.SD_SCALE_FACTOR).clamp(-1.0, 1.0)
        f = ref.conditioner.face_ID_model.facenet(nets.arcface_input(img * region))
        idl = torch.mean(1.0 - torch.sum(f * f_ref, dim=-1))
        return torch.stack([idl] + [torch.mean(ref.lpips(pool(img, f), g)) for f, g in zip(scales, gts)])

    sums = sum(checkpoint(towers, x, use_reentrant=False) if x.requires_grad and torch.is_grad_enabled()
               else towers(x) for x in latents)
    total = loss_simple + rc["id_weight"] * sums[0] / len(latents) + rc["lpips_weight"] * torch.sum(sums[1:])
    return total * (target.shape[0] / total_rows)


class AdamW:
    """optax.adamw over the given parameters, in fp32: Adam's moments, the
    bias corrections, decoupled weight decay, the learning rate of the
    update count `lr(count)`."""

    def __init__(self, params: dict, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
        self.params, self.lr = params, lr
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict):
        lr = self.lr(self.count)
        self.count += 1
        bc1, bc2 = 1.0 - self.b1**self.count, 1.0 - self.b2**self.count
        for k, p in self.params.items():
            g = grads[k] if grads[k] is not None else torch.zeros_like(p)
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps) + self.wd * p
            p.sub_(lr * upd)


def warmup_lr(base: float, warmup_steps: int):
    """optax.linear_schedule(base * 1e-6, base, warmup_steps): the rate at
    update count c (held at the start value when warmup_steps <= 0)."""
    start = base * 1e-6
    if warmup_steps <= 0:
        return lambda c: start
    return lambda c: (start - base) * (1.0 - min(c, warmup_steps) / warmup_steps) + base


def run_steps(ref: TrainReference, batches: list, draws: list, block: int = 2, on_grads=None):
    """Run the steps, one per (batch, draws), on `ref` in place with AdamW
    as the configuration's "train" group sets it. batches: NCHW rows;
    on_grads(step, {name: grad}) sees each step's gradients. Returns the
    steps' losses."""
    tc = ref.cfg["train"]
    ref.freeze()
    params = ref.trainable()
    opt = AdamW(params, warmup_lr(tc["learning_rate"], ref.cfg["warmup_steps"]), weight_decay=tc["weight_decay"])
    losses = []
    for i, (rows, dr) in enumerate(zip(batches, draws)):
        for p in params.values():
            p.grad = None
        n = rows["target"].shape[0]
        flip = rows["ref_clip224"].flip(0)
        total = 0.0
        for lo in range(0, n, block):
            sl = slice(lo, lo + block)
            part = loss(ref, {k: v[sl] for k, v in rows.items()}, flip[sl],
                        {k: v[sl] for k, v in dr.items()}, n)
            part.backward()
            total += float(part.detach())
        grads = {k: p.grad for k, p in params.items()}
        if on_grads is not None:
            on_grads(i, grads)
        opt.step(grads)
        losses.append(total)
    return losses

