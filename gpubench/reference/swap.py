"""The pre-cropped face swap in plain fp32: the reference the swap cells
are judged by.

Per batch, as REFace's test bench runs it: the conditioning (CLIP on the
source and the target, IR-SE-50 on the source, the landmark projection),
the VAE encode of the masked target with its posterior sampled, the mask
resized to latent size, DDIM with classifier-free guidance (the
unconditional context is the learnable null token; eta = 0), the VAE decode
clamped to [-1, 1]. Every UNet evaluation runs the guidance pair as one
doubled batch, without the program's prefix dedup: the values are the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench.reference import nets


class SwapReference(torch.nn.Module):
    """The three towers of a swap configuration ("unet", "vae" and the
    conditioner's groups), with the program's state-dict names under
    "unet.", "vae." and "conditioner."."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.unet = nets.UNet(cfg["unet"])
        self.vae = nets.AutoencoderKL(cfg["vae"])
        self.conditioner = nets.Conditioner(cfg)

    @torch.no_grad()
    def swap(self, batch: dict, posterior_noise, x_T):
        """batch: NCHW fp32 target and inpaint (B,3,S,S) in [-1,1], mask
        (B,1,S,S) with 1 = keep, ref_clip224 (B,3,224,224), landmarks (B,136);
        posterior_noise and x_T (B,4,h,w). Returns (B,S,S,3) in [-1,1]."""
        cfg = self.cfg
        target, mask = batch["target"], batch["mask"]
        c = self.conditioner(batch["ref_clip224"], nets.clip_input(target), batch["landmarks"])
        uc = self.conditioner.learnable_vector.expand_as(c)
        mean, std = self.vae.posterior(batch["inpaint"])
        z_in = (mean + std * posterior_noise) * nets.SD_SCALE_FACTOR
        hw = z_in.shape[-1]
        rest = torch.cat([z_in, F.interpolate(mask, size=(hw, hw), mode="bilinear",
                                              align_corners=False)], dim=1)
        ts, a, a_prev = nets.ddim_tables(cfg["ddim_steps"])
        s = cfg["cfg_scale"]
        x, b = x_T, x_T.shape[0]
        for i, t in enumerate(ts.tolist()):
            x9 = torch.cat([x, rest], dim=1)
            tt = torch.full((2 * b,), t, dtype=torch.int32, device=x.device)
            eps2 = self.unet(torch.cat([x9, x9]), tt, torch.cat([uc, c]))
            eps = eps2[:b] + s * (eps2[b:] - eps2[:b])
            x, _ = nets.ddim_update(x, eps, float(a[i]), float(a_prev[i]))
        img = self.vae.decode(x / nets.SD_SCALE_FACTOR).clamp(-1.0, 1.0)
        return img.permute(0, 2, 3, 1)
