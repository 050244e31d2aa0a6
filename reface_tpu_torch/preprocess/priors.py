"""Prior images for the test bench's start from the target (port of
reface_tpu/preprocess/priors.py).

The reference (scripts/make_priors.py) replaces the masked target-face
pixels with source pixels found by DIFT diffusion-feature correspondence
(argmax cosine between SD-UNet features at t=261, make_priors.py:60-151);
the prior's noised latent seeds the DDIM chain (inference_test_bench.py:
414-436, `FaceSwapper.swap(prior_image=...)`). Two builders, on the device:
  - `landmark_tps_prior`: a 68-landmark TPS warp (the classical equivalent);
  - `dift_prior` with `make_unet_feats_fn`: the swap UNet's own decoder
    features at a noised timestep drive the argmax-cosine correspondence,
    on a `grid`^2 lattice upsampled to the image (the reference's full
    512^2 x 512^2 similarity bounded at grid^4 * C).

Images are (H, W, 3) in [-1, 1] and masks (H, W, 1), the JAX package's
layout; features are (h, w, C).
"""

from __future__ import annotations

import contextlib

import torch

from reface_tpu_torch.core.schedules import DiffusionSchedule
from reface_tpu_torch.ops.resize import resize_bilinear_aa, resize_nearest
from reface_tpu_torch.preprocess.tps import grid_sample_2d, tps_warp

__all__ = ["landmark_tps_prior", "dift_prior", "dift_index", "make_unet_feats_fn"]

# rows of the cosine product a chunk: 4096 x 16384 fp32 is 256 MiB
_ROWS = 4096


def _nchw1(img: torch.Tensor) -> torch.Tensor:
    return img.permute(2, 0, 1)[None]


def _hwc(x: torch.Tensor) -> torch.Tensor:
    return x[0].permute(1, 2, 0)


def landmark_tps_prior(target_image, source_image, target_lm, source_lm, face_mask):
    """Warp the source face onto the target's landmark geometry: a TPS from
    the target's (68, 2) pixel landmarks to the source's (a backward warp)
    samples the source, composited over the target inside the face mask.
    Computed in the target image's dtype."""
    h, w, _ = target_image.shape
    kw = dict(dtype=target_image.dtype, device=target_image.device)
    size = torch.tensor([float(w), float(h)], **kw)
    # grid_sample_2d's half-pixel convention: pixel i's centre is (2i+1)/S - 1
    to_norm = lambda lm: (2.0 * lm.to(**kw) + 1.0) / size - 1.0
    yy, xx = torch.meshgrid(torch.arange(h, **kw), torch.arange(w, **kw), indexing="ij")
    pts = to_norm(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
    mapped = tps_warp(to_norm(target_lm), to_norm(source_lm), pts)
    warped = _hwc(grid_sample_2d(_nchw1(source_image), mapped.reshape(1, h, w, 2)))
    return target_image * (1 - face_mask) + warped * face_mask


def make_unet_feats_fn(modules, t: int = 261, ensemble: int = 4, seed: int = 0,
                       noises=None):
    """Diffusion-feature extractor over the swap UNet (the SDFeaturizer role,
    make_priors.py:7,18-23: features at t=261, averaged over `ensemble`
    noise draws).

    modules: a SwapModules / FaceSwapper. Returns feats_fn: (H, W, 3) image
    in [-1, 1] -> (h, w, C) fp32 features, the first decoder tap at latent/4
    (DIFT's up_ft_index=1). The 9-channel inpainting UNet sees [z_t, z,
    ones] (nothing masked) and the learnable null conditioning; z is the
    posterior's mode. Draw e is torch.randn from a generator on the modules'
    device seeded seed * 1000 + e; `noises`, a list of `ensemble` latent-
    shaped tensors, replaces the draws (the JAX package draws from
    jax.random.key(seed * 1000 + e)).
    """
    schedule = DiffusionSchedule.create()

    @torch.inference_mode()
    def feats_fn(image_pm1: torch.Tensor) -> torch.Tensor:
        dev = modules.device
        z = modules.encode_latent(_nchw1(torch.as_tensor(image_pm1, device=dev).float()))
        hw = z.shape[-1]
        tb = torch.full((1,), t, dtype=torch.long, device=dev)
        ctx = modules.conditioner.null_conditioning(1)
        ones = torch.ones_like(z[:, :1])
        acc = None
        for e in range(ensemble):
            if noises is not None:
                noise = torch.as_tensor(noises[e], device=dev, dtype=z.dtype)
            else:
                gen = torch.Generator(device=dev).manual_seed(seed * 1000 + e)
                noise = torch.randn(z.shape, generator=gen, device=dev, dtype=z.dtype)
            x9 = torch.cat([schedule.q_sample(z, tb, noise), z, ones], dim=1)
            _, feats = modules.unet(x9, tb, ctx, return_features=True)
            f = next((f for f in feats if f.shape[-1] == max(hw // 4, 1)), feats[0])
            acc = f if acc is None else acc + f
        return (acc[0] / ensemble).float().permute(1, 2, 0)

    return feats_fn


@contextlib.contextmanager
def _fp32_products():
    """fp32 matmuls, TF32 off, for a product whose argmax is taken."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def dift_index(ft: torch.Tensor, fs: torch.Tensor, grid: int = 128) -> torch.Tensor:
    """For every cell of the grid^2 lattice of target features ft, the
    lattice cell of the source features fs with the largest cosine (the
    first among equals). (h, w, C) features -> (grid^2,) int64."""

    def at_grid(f):
        g = _hwc(resize_bilinear_aa(_nchw1(f.float()), grid, grid)).reshape(grid * grid, -1)
        return g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-8)

    a, b = at_grid(ft), at_grid(fs)
    with _fp32_products():
        return torch.cat([torch.argmax(a[i:i + _ROWS] @ b.T, dim=1)
                          for i in range(0, a.shape[0], _ROWS)])


def dift_prior(target_image, source_image, face_mask, feats_fn, grid: int = 128):
    """Feature-correspondence prior (make_priors.py:103-151 semantics): every
    target cell takes the source pixel at the centre of its argmax-cosine
    source cell (dift_index), the field nearest-upsampled to the image, and
    the result is pasted into the target's face region."""
    h, w, _ = target_image.shape
    idx = dift_index(feats_fn(target_image), feats_fn(source_image), grid)
    sy = torch.div(idx, grid, rounding_mode="floor").float()
    sx = (idx % grid).float()
    field = torch.stack([(2.0 * sx + 1.0) / grid - 1.0, (2.0 * sy + 1.0) / grid - 1.0],
                        dim=-1).reshape(grid, grid, 2)
    field = _hwc(resize_nearest(_nchw1(field), h, w))
    warped = _hwc(grid_sample_2d(_nchw1(source_image), field[None]))
    return target_image * (1 - face_mask) + warped * face_mask
