"""End-to-end pre-cropped face swap (port of reface_tpu/pipelines/swap.py).

Per batch: fused conditioning (CLIP on source and target as one 2B batch,
ArcFace, landmarks), VAE encode of the masked target, the mask resized to
latent size with torch semantics, the sampler (DDIM-50 with CFG 3,
unconditional half first, exact prefix dedup, by default; or PLMS, or
DPM-Solver++(2M)), VAE decode and clamp. vae_tile / unet_tile run the VAE
and the UNet on overlapping tiles, all tiles in one batched call
(parallel/tiling.py); the quant fields of the towers' configs select the
int8 serving modes (ops/quant.py). `FaceSwapper.swap_guided` runs the
gradient-guided sampler (diffusion/ddim_guided.py) with the ID, segmentation
and expression terms of diffusion/guidance.py.

The public `FaceSwapper.swap` keeps the JAX package's layout at its
boundary: NHWC (B,512,512,3) images in [-1,1] in and out. Inside, the port
is NCHW. It runs on CUDA unless the caller passes device="cpu"; it never
drops to the CPU by itself. While a profiler runs, `swap` records the spans
`swap.condition`, `swap.encode`, `swap.sample` and `swap.decode` under
`swap` (core/profiling.py).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from reface_tpu_torch.core.profiling import span
from reface_tpu_torch.core.schedules import DDIMTables, DiffusionSchedule
from reface_tpu_torch.diffusion.ddim import ddim_sample
from reface_tpu_torch.diffusion.dpm_solver import dpm_solver_sample
from reface_tpu_torch.diffusion.plms import plms_sample
from reface_tpu_torch.nn.arcface import (
    ARC_FACE_CROP,
    CLIP_MEAN,
    CLIP_STD,
    ArcFaceConfig,
    BatchNormInference,
    PReLU,
)
from reface_tpu_torch.nn.clip import CLIPVisionConfig
from reface_tpu_torch.nn.conditioner import ConditionerConfig, REFaceConditioner
from reface_tpu_torch.nn.layers import Conv2d, GroupNorm32, LayerNorm, Linear
from reface_tpu_torch.nn.unet import UNetConfig, UNetModel
from reface_tpu_torch.nn.vae import SD_SCALE_FACTOR, AutoencoderKL, VAEConfig
from reface_tpu_torch.ops.pooling import adaptive_avg_pool2d
from reface_tpu_torch.ops.resize import resize_bilinear_aa, resize_bilinear_no_aa
from reface_tpu_torch.parallel.tiling import tiled_apply

__all__ = ["SwapConfig", "SwapModules", "FaceSwapper", "clip_normalize",
           "un_norm", "init_params", "tiny_swap_config", "resolve_device",
           "SAMPLERS"]

SAMPLERS = ("ddim", "plms", "dpm")


def un_norm(x):
    """[-1,1] -> [0,1]."""
    return (x + 1.0) / 2.0


def clip_normalize(x01, size: int = 224):
    """[0,1] NCHW image -> CLIP-normalized at size x size (bilinear with
    antialias, jax.image.resize's semantics)."""
    x01 = resize_bilinear_aa(x01, size, size)
    r = lambda a: torch.as_tensor(a, device=x01.device).reshape(1, 3, 1, 1)
    return (x01 - r(CLIP_MEAN)) / r(CLIP_STD)


@dataclasses.dataclass(frozen=True)
class SwapConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    conditioner: ConditionerConfig = ConditionerConfig()
    ddim_steps: int = 50
    cfg_scale: float = 3.0
    # CFG only on the first cfg_steps steps (0 = CFG on every step)
    cfg_steps: int = 0
    eta: float = 0.0
    sampler: str = "ddim"  # "ddim" | "plms" | "dpm" (DPM-Solver++(2M))
    # timestep subset: "uniform"/"quad" (the reference's) or "lam_uniform"
    # (uniform in half-log-SNR, the grid DPM-Solver++ wants)
    ddim_discretize: str = "uniform"
    image_size: int = 512
    latent_size: int = 64
    sample_posterior: bool = True  # the reference samples the VAE posterior
    start_noise_t: int = 999  # target_start_noise_t for prior starts
    # overlapping tiles for the VAE, in latent pixels (times the VAE's
    # factor for the encode); 0 = off
    vae_tile: int = 0
    vae_tile_stride: int = 0  # 0 = vae_tile // 2
    # overlapping tiles for the UNet (each tile with the same context); 0 = off
    unet_tile: int = 0
    unet_tile_stride: int = 0  # 0 = unet_tile // 2
    # exact CFG prefix dedup (UNetModel cfg_expand)
    cfg_dedup: bool = True


def resolve_device(device=None) -> torch.device:
    """The given device, else CUDA; raises when no CUDA device is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return torch.device("cuda")


@torch.no_grad()
def init_params(module: torch.nn.Module, seed: int = 0, dezero: bool = False):
    """Seeded random init of every parameter of `module`, on its device.

    Linear/Conv weights are LeCun-normal (std 1/sqrt(fan_in)), biases zero,
    norms (1, 0), PReLU 0.25, CLIP embeddings N(0, 0.02), the null token
    N(0, 1); the layers the reference zero-initialises stay zero unless
    `dezero`, which then gives every all-zero parameter N(0, 0.02) values,
    so that the output depends on every layer.
    """
    params = list(module.parameters())
    if not params:
        return module
    gen = torch.Generator(device=params[0].device).manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d)):
            w = m.weight
            if getattr(m, "zero_init", False):
                w.zero_()
            else:
                w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (GroupNorm32, LayerNorm, BatchNormInference)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, PReLU):
            m.weight.fill_(0.25)
        elif isinstance(m, torch.nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=gen)
    for name, p in module.named_parameters():
        if name.endswith("class_embedding"):
            p.normal_(0.0, 0.02, generator=gen)
        elif name.endswith("learnable_vector"):
            p.normal_(0.0, 1.0, generator=gen)
    if dezero:
        for p in module.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)
    return module


class SwapModules:
    """The three towers on one device, with per-stage helpers.

    param_dtype: storage dtype of the UNet's and the conditioner heads'
    weights (default: their compute dtype); the trainer passes fp32."""

    def __init__(self, config: SwapConfig, device=None, param_dtype=None):
        self.config = config
        self.device = resolve_device(device)
        self.unet = UNetModel(config.unet, device=self.device,
                              param_dtype=param_dtype).eval()
        self.vae = AutoencoderKL(config.vae, device=self.device).eval()
        self.conditioner = REFaceConditioner(config.conditioner, device=self.device,
                                             param_dtype=param_dtype).eval()
        for m in self.towers().values():
            m.requires_grad_(False)

    def towers(self) -> dict[str, torch.nn.Module]:
        return {"unet": self.unet, "vae": self.vae, "conditioner": self.conditioner}

    def load_params(self, params: dict) -> None:
        """Load {"unet": state_dict, "vae": ..., "conditioner": ...}."""
        for name, module in self.towers().items():
            module.load_state_dict(params[name])

    @property
    def _vae_factor(self) -> int:
        return self.config.image_size // self.config.latent_size

    def encode_latent(self, image, generator=None):
        """(B,3,S,S) -> (B,4,S/f,S/f) scaled latent; the posterior sampled
        from `generator`, else its mode. Tiled above vae_tile * f pixels."""
        cfg = self.config

        def enc(img):
            post = self.vae.encode(img)
            z = post.sample(generator) if generator is not None else post.mode()
            return z * SD_SCALE_FACTOR

        f = self._vae_factor
        if cfg.vae_tile and image.shape[2] > cfg.vae_tile * f:
            stride = (cfg.vae_tile_stride or cfg.vae_tile // 2) * f
            return tiled_apply(enc, image, cfg.vae_tile * f, stride,
                               out_channels=4, scale=1.0 / f)
        return enc(image)

    def decode_latent(self, z, for_grad: bool = False):
        """Scaled latent -> image clamped to [-1,1]; tiled above vae_tile.
        for_grad: the decoder built for a backward through this call
        (AutoencoderKL.decode), as the guided sampler differentiates it."""
        cfg = self.config

        def dec(zz):
            return torch.clamp(self.vae.decode(zz / SD_SCALE_FACTOR, for_grad), -1.0, 1.0)

        if cfg.vae_tile and z.shape[2] > cfg.vae_tile:
            stride = cfg.vae_tile_stride or cfg.vae_tile // 2
            return tiled_apply(dec, z, cfg.vae_tile, stride, out_channels=3,
                               scale=self._vae_factor)
        return dec(z)

    def build_context(self, ref_clip224, target_image, landmarks):
        """Fused conditioning: CLIP(src)+CLIP(tar)+ID(src)+landmarks(tar)."""
        tar224 = clip_normalize(un_norm(target_image))
        c = self.conditioner(ref_clip224, tar224, landmarks)
        return c, self.conditioner.null_conditioning(c.shape[0])

    def embed_id(self, img_pm1):
        """(B,3,S,S) image in [-1,1] -> (B,512) ArcFace features by the
        IDLoss protocol (ddpm.py:112-124): pool to 256, ARC_FACE_CROP, pool
        to 112, the conditioner's IR-SE-50."""
        x = adaptive_avg_pool2d(img_pm1, 256, 256)
        top, bottom, left, right = ARC_FACE_CROP
        x = adaptive_avg_pool2d(x[:, :, top:bottom, left:right], 112, 112)
        return self.conditioner.face_ID_model.facenet(x)

    def unet_eps(self, x9, t, context):
        """eps of the UNet; above unet_tile latent pixels on overlapping
        tiles, each with its sample's t and context (repeated by whole
        batches, as the tiles are grouped tile-major), in one batched call."""
        cfg = self.config
        if cfg.unet_tile and x9.shape[2] > cfg.unet_tile:
            stride = cfg.unet_tile_stride or cfg.unet_tile // 2
            b = x9.shape[0]

            def fn(tiles):
                n = tiles.shape[0] // b
                return self.unet(tiles, t.repeat(n), context.repeat(n, 1, 1))

            return tiled_apply(fn, x9, cfg.unet_tile, stride, out_channels=4)
        return self.unet(x9, t, context)

    def unet_eps_cfg_dedup(self, x9, t, context_pair):
        """x9/t at B, context_pair at 2B (uncond first) -> eps at 2B."""
        return self.unet(x9, t, context_pair, cfg_expand=True)


def _nchw(x, device):
    return torch.as_tensor(x, device=device).float().permute(0, 3, 1, 2).contiguous()


class FaceSwapper(SwapModules):
    """SwapModules + weights + sampler tables, exposing `swap`.

    params: {"unet", "vae", "conditioner"} state dicts; None gives a seeded
    random init (init_params, `seed` plus the tower's index).
    """

    def __init__(self, config: SwapConfig, params: dict | None = None,
                 device=None, seed: int = 0):
        if config.sampler not in SAMPLERS:
            raise ValueError(f"sampler={config.sampler!r}: expected one of {SAMPLERS}")
        if config.sampler in ("plms", "dpm") and config.eta != 0.0:
            # both solve the deterministic probability-flow ODE; a stochastic
            # eta would silently run another process than the config asks for
            raise ValueError(
                f"sampler={config.sampler!r} is deterministic (eta=0 only); "
                f"got eta={config.eta}. Use sampler='ddim' for eta>0.")
        super().__init__(config, device)
        if params is None:
            for i, m in enumerate(self.towers().values()):
                init_params(m, seed=seed + i)
        else:
            self.load_params(params)
        self.schedule = DiffusionSchedule.create()
        self.tables = DDIMTables.create(self.schedule, config.ddim_steps,
                                        eta=config.eta,
                                        method=config.ddim_discretize)

    @torch.inference_mode()
    def swap(self, target_image, inpaint_image, inpaint_mask, ref_clip224,
             landmarks=None, generator: torch.Generator | None = None,
             x_T=None, prior_image=None):
        """Run one swap; returns (B,S,S,3) fp32 images in [-1,1].

        Inputs are NHWC in [-1,1] (ref_clip224 CLIP-normalized, inpaint_mask
        1 = keep); landmarks (B,136) target pixel coordinates; x_T an
        optional fixed (B,h,w,4) initial latent; prior_image an optional
        (B,S,S,3) image to start from. `generator` (on the swapper's device)
        draws the posterior sample, x_T and any eta noise.
        """
        cfg, dev = self.config, self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        with span("swap"):
            with span("swap.condition"):
                target = _nchw(target_image, dev)
                c, uc = self.build_context(_nchw(ref_clip224, dev), target,
                                           None if landmarks is None
                                           else torch.as_tensor(landmarks, device=dev))
            with span("swap.encode"):
                z_inpaint = self.encode_latent(
                    _nchw(inpaint_image, dev), generator if cfg.sample_posterior else None)
                b, hw = target.shape[0], cfg.latent_size
                mask_latent = resize_bilinear_no_aa(_nchw(inpaint_mask, dev), hw, hw)
                if x_T is not None:
                    x_T = _nchw(x_T, dev)
                elif prior_image is not None:
                    z_p = self.encode_latent(_nchw(prior_image, dev), generator)
                    t0 = torch.full((b,), cfg.start_noise_t, dtype=torch.long)
                    noise = torch.randn(z_p.shape, generator=generator, device=dev)
                    x_T = self.schedule.q_sample(z_p, t0, noise)
                else:
                    x_T = torch.randn((b, 4, hw, hw), generator=generator, device=dev)
            # the dedup's cfg_expand bypasses unet_eps: the tiles win over it
            dedup = (self.unet_eps_cfg_dedup if cfg.cfg_dedup and not cfg.unet_tile
                     else None)
            args = (self.unet_eps, x_T, c, uc, z_inpaint, mask_latent, self.tables,
                    cfg.cfg_scale)
            with span("swap.sample"):
                if cfg.sampler == "plms":
                    z = plms_sample(*args)
                elif cfg.sampler == "dpm":
                    z = dpm_solver_sample(*args, cfg_steps=cfg.cfg_steps or None,
                                          dedup_model_fn=dedup)
                else:
                    z = ddim_sample(*args, eta=cfg.eta,
                                    generator=generator if cfg.eta != 0 else None,
                                    cfg_steps=cfg.cfg_steps or None, dedup_model_fn=dedup)
            with span("swap.decode"):
                return self.decode_latent(z).permute(0, 2, 3, 1).contiguous()

    def swap_guided(self, target_image, inpaint_image, inpaint_mask, ref_clip224,
                    landmarks=None, generator: torch.Generator | None = None, x_T=None,
                    guidance: tuple = ("id",), guidance_scale: float = 1.0,
                    id_weight: float = 1.0, seg_weight: float = 10.0,
                    exp_weight: float = 100.0, seg_logits_fn=None, exp_coeff_fn=None):
        """Gradient-guided swap (ddim_guided.py:380-609 semantics); returns
        (B,S,S,3) fp32 images in [-1,1]. `swap`'s arguments, plus:

        guidance: a subset of ("id", "seg", "exp"). "id" uses the swapper's
        own ArcFace by the IDLoss protocol (embed_id) against the source
        taken back from ref_clip224; "seg" needs seg_logits_fn ((B,3,H,W) in
        [-1,1] -> (B,19,H,W) BiSeNet logits), "exp" exp_coeff_fn ((B,3,H,W)
        in [0,1] -> (B,64) D3DFR expression coefficients), which the driver
        builds from its towers (cli/swap.py). The ID and expression terms
        read the decode in the inpaint region 1 - inpaint_mask.

        Runs outside inference mode whatever the caller's (the raw pipeline
        calls it from inside): its inputs are copied out of it, the UNet and
        the encodes run under no_grad, and each step's decode is built for
        the backward (SwapModules.decode_latent(for_grad=True)).
        """
        with torch.inference_mode(False), torch.no_grad():
            return self._swap_guided(
                target_image, inpaint_image, inpaint_mask, ref_clip224, landmarks,
                generator, x_T, tuple(guidance), guidance_scale, id_weight, seg_weight,
                exp_weight, seg_logits_fn, exp_coeff_fn)

    def _swap_guided(self, target_image, inpaint_image, inpaint_mask, ref_clip224,
                     landmarks, generator, x_T, guidance, guidance_scale, id_weight,
                     seg_weight, exp_weight, seg_logits_fn, exp_coeff_fn):
        from reface_tpu_torch.diffusion.ddim_guided import guided_ddim_sample
        from reface_tpu_torch.diffusion.guidance import (
            combine_guidance,
            make_expression_guidance,
            make_id_guidance,
            make_seg_guidance,
        )

        bad = set(guidance) - {"id", "seg", "exp"}
        if bad:
            raise ValueError(f"unknown guidance terms: {sorted(bad)}")
        if "seg" in guidance and seg_logits_fn is None:
            raise ValueError('guidance "seg" needs seg_logits_fn')
        if "exp" in guidance and exp_coeff_fn is None:
            raise ValueError('guidance "exp" needs exp_coeff_fn')
        cfg, dev = self.config, self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        # copies made here are ordinary tensors, which autograd may save
        own = lambda a: _nchw(a, dev).clone()
        target, ref, mask = own(target_image), own(ref_clip224), own(inpaint_mask)
        c, uc = self.build_context(ref, target, None if landmarks is None
                                   else torch.as_tensor(landmarks, device=dev).clone())
        z_inpaint = self.encode_latent(
            own(inpaint_image), generator if cfg.sample_posterior else None)
        b, hw = target.shape[0], cfg.latent_size
        mask_latent = resize_bilinear_no_aa(mask, hw, hw)
        if x_T is not None:
            x_T = own(x_T)
        else:
            x_T = torch.randn((b, 4, hw, hw), generator=generator, device=dev)

        decode_fn = functools.partial(self.decode_latent, for_grad=True)
        inpaint_region = 1.0 - mask  # 1 = the generated region
        fns = []
        if "id" in guidance:
            r = lambda a: torch.as_tensor(a, device=dev).reshape(1, 3, 1, 1)
            src_pm1 = (ref * r(CLIP_STD) + r(CLIP_MEAN)) * 2.0 - 1.0
            fns.append(make_id_guidance(decode_fn, self.embed_id, src_pm1,
                                        inpaint_region=inpaint_region, weight=id_weight))
        if "seg" in guidance:
            fns.append(make_seg_guidance(decode_fn, seg_logits_fn, target, weight=seg_weight))
        if "exp" in guidance:
            fns.append(make_expression_guidance(decode_fn, exp_coeff_fn, target,
                                                inpaint_region=inpaint_region,
                                                weight=exp_weight))
        dedup = (self.unet_eps_cfg_dedup if cfg.cfg_dedup and not cfg.unet_tile
                 else None)
        z = guided_ddim_sample(self.unet_eps, combine_guidance(*fns), x_T, c, uc, z_inpaint,
                               mask_latent, self.tables, cfg_scale=cfg.cfg_scale,
                               guidance_scale=guidance_scale, dedup_model_fn=dedup)
        return self.decode_latent(z).permute(0, 2, 3, 1).contiguous()


def tiny_swap_config(image_size: int = 64, ddim_steps: int = 4) -> SwapConfig:
    """A miniature fp32 config for tests and CPU smoke runs (the JAX
    package's tiny_swap_config)."""
    f32 = torch.float32
    return SwapConfig(
        unet=UNetConfig(model_channels=32, num_heads=4, channel_mult=(1, 2),
                        attention_resolutions=(1, 2), dtype=f32),
        vae=VAEConfig(ch=16, ch_mult=(1, 2, 2, 2), num_res_blocks=1, dtype=f32),
        conditioner=ConditionerConfig(
            clip=CLIPVisionConfig(hidden=64, layers=1, heads=4, patch=56,
                                  image_size=224, dtype=f32),
            arcface=ArcFaceConfig(depths=(8, 16, 16, 16), units=(1, 1, 1, 1),
                                  dtype=f32),
        ),
        ddim_steps=ddim_steps,
        image_size=image_size,
        latent_size=image_size // 8,
    )
