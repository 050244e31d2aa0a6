"""Ready-made guidance losses for the gradient-guided DDIM sampler (port of
reface_tpu/diffusion/guidance.py).

The reference's experimental guidance terms on the differentiably decoded
pred_x0 image (ldm/models/diffusion/ddim_guided.py:380-609; the ID and 3DMM
terms read the inpaint-region-masked decode, ddim_guided.py:419-424, the
segmentation term the full decode, :434-437):
  - ID cosine loss against the source through the ArcFace IDLoss protocol,
    active for 5 < t < 500 (ddim_guided.py:545-549);
  - segmentation consistency: L1 between BiSeNet 19-class logit maps of the
    prediction and the target over classes [skin, mouth, u_lip, l_lip] =
    [1, 11, 12, 13] at 256 px, weight 10 (ddim_guided.py:434-456);
  - 3DMM expression: 1 - cosine between D3DFR expression coefficients
    (80:144) of prediction and target, weight 100 (ddim_guided.py:460-508).

Each builder returns a `GuidanceTerm`: called as fn(pred_x0 latent, t) it
gives the JAX builder's scalar (0 with a zero gradient outside its gate);
`active(t)` says whether its gradient can be non-zero at t. Under jax.jit
XLA merges the terms' identical decodes; here `combine_guidance` decodes
pred_x0 once a step for all terms that share a decode function, multiplies
by each inpaint region once, and hands every active term its image: the
same sum, one decoder forward and backward a step. Images are NCHW in
[-1, 1]; regions (B, 1, H, W), 1 = the generated region.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from reface_tpu_torch.ops.resize import resize_bilinear_aa

__all__ = ["GuidanceTerm", "make_id_guidance", "make_seg_guidance",
           "make_expression_guidance", "combine_guidance", "masked_image"]

GuidanceFn = Callable[[torch.Tensor, int], torch.Tensor]


def masked_image(img, inpaint_region):
    """The decoded image kept in the inpainted region only (ddim_guided.py:
    419-424: masks = 1 - resize(mask); im * masks); the region resized
    bilinearly (antialiased when it shrinks) where its size differs."""
    if inpaint_region is None:
        return img
    region = inpaint_region
    if region.shape[-2:] != img.shape[-2:]:
        region = resize_bilinear_aa(region, img.shape[-2], img.shape[-1])
    return img * region


def _masked_decode(decode_fn, pred_x0, inpaint_region):
    """Decode the latent and keep only the inpainted region."""
    return masked_image(decode_fn(pred_x0), inpaint_region)


class GuidanceTerm:
    """One guidance loss: `loss_of_image` on decode_fn(pred_x0), masked by
    `region` where one is given, inside the timestep gate `gate(t)`."""

    def __init__(self, decode_fn, loss_of_image, region=None, gate=None):
        self.decode_fn, self.loss_of_image = decode_fn, loss_of_image
        self.region, self.gate = region, gate

    def active(self, t) -> bool:
        return self.gate is None or bool(self.gate(int(t)))

    def __call__(self, pred_x0, t):
        if not self.active(t):  # jnp.where(gate, loss, 0): 0, zero gradient
            return (pred_x0 * 0.0).sum()
        return self.loss_of_image(_masked_decode(self.decode_fn, pred_x0, self.region))


def make_id_guidance(decode_fn, embed_id_fn, source_pm1, inpaint_region=None,
                     weight: float = 1.0, t_range: tuple[int, int] = (5, 500)) -> GuidanceTerm:
    """ID cosine guidance: 1 - <f(pred_masked), f(source)>.

    decode_fn: latent (B,4,h,w) -> image (B,3,S,S) in [-1,1], differentiable;
    embed_id_fn: image in [-1,1] -> (B,512) l2-normed ArcFace features (the
    IDLoss pool/crop protocol, ddpm.py:112-124); inpaint_region: (B,1,*,*),
    1 = the region being generated; t_range: the open window of active
    timesteps (ddim_guided.py:545: 5 < t < 500).
    """
    with torch.no_grad():
        src_feats = embed_id_fn(source_pm1).float()

    def loss_of_image(img):
        f = embed_id_fn(img).float()
        return weight * torch.mean(1.0 - (f * src_feats).sum(-1))

    return GuidanceTerm(decode_fn, loss_of_image, inpaint_region,
                        gate=lambda t: t_range[0] < t < t_range[1])


def make_seg_guidance(decode_fn, seg_logits_fn, target_pm1,
                      classes: Sequence[int] = (1, 11, 12, 13),
                      weight: float = 10.0) -> GuidanceTerm:
    """Segmentation-consistency guidance: L1 between BiSeNet logit maps of
    the prediction and the target over `classes` (ddim_guided.py:434-456;
    the 19-class face-parsing vocabulary: 1 skin, 11 mouth, 12 u_lip, 13
    l_lip), on the full decode.

    seg_logits_fn: image in [-1,1] -> (B, 19, H, W) logits.
    """
    idx = list(classes)
    with torch.no_grad():
        tgt = seg_logits_fn(target_pm1)[:, idx].float()

    def loss_of_image(img):
        diff = (seg_logits_fn(img)[:, idx].float() - tgt).abs()
        return weight * diff.mean() * len(idx)

    return GuidanceTerm(decode_fn, loss_of_image)


def make_expression_guidance(decode_fn, coeff_fn, target_pm1, inpaint_region=None,
                             weight: float = 100.0) -> GuidanceTerm:
    """3DMM expression guidance: 1 - cos(exp(pred), exp(target)) summed over
    the batch (ddim_guided.py:460-508; the reference reads the masked
    decode, im_rec = (pred_x0_im_masked + 1) / 2).

    coeff_fn: image in [0,1] -> (B, 64) D3DFR expression coefficients
    (coeffs[80:144]); inpaint_region: (B,1,*,*), 1 = the generated region.
    """
    with torch.no_grad():
        tgt = coeff_fn((target_pm1 + 1.0) / 2.0).float()
    tgt_norm = torch.linalg.norm(tgt, dim=-1)

    def loss_of_image(img):
        exp = coeff_fn((img + 1.0) / 2.0).float()
        cos = (exp * tgt).sum(-1) / (torch.linalg.norm(exp, dim=-1) * tgt_norm + 1e-8)
        return weight * (1.0 - cos).sum()

    return GuidanceTerm(decode_fn, loss_of_image, inpaint_region)


class _Combined:
    """The sum of guidance terms with one decode of pred_x0 a step for the
    active terms that share a decode function (module docstring)."""

    def __init__(self, fns):
        self.fns = fns

    def active(self, t) -> bool:
        return any(not isinstance(g, GuidanceTerm) or g.active(t) for g in self.fns)

    def __call__(self, pred_x0, t):
        total = pred_x0.new_zeros(())
        decoded, masked = {}, {}
        for g in self.fns:
            if not isinstance(g, GuidanceTerm):
                total = total + g(pred_x0, t)
                continue
            if not g.active(t):
                continue
            key = id(g.decode_fn)
            if key not in decoded:
                decoded[key] = g.decode_fn(pred_x0)
            mkey = (key, id(g.region))
            if mkey not in masked:
                masked[mkey] = masked_image(decoded[key], g.region)
            total = total + g.loss_of_image(masked[mkey])
        return total


def combine_guidance(*fns: GuidanceFn) -> _Combined:
    return _Combined(fns)
