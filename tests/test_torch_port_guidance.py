"""The gradient-guided swap of the port (reface_tpu_torch/diffusion/
guidance.py, diffusion/ddim_guided.py, FaceSwapper.swap_guided) against the
JAX package's, fp32, on the CPU.

The guidance builders run on toy towers written in both packages (a decode
that maps the latent's 4 channels to 3 and upsamples by 4, an embedding of
the 4 x 4 mean-pooled image, a per-pixel 19-class head, a pooled 64-
coefficient head), so their losses and gradients are held to jax.grad at
little cost; the sampler runs on a toy eps model; swap_guided end to end on
tiny_swap_config(64, 4) with all three terms (the ID term through the
swapper's own VAE decoder and ArcFace, the segmentation and expression
terms through the toy heads), x_T drawn in JAX from the key split JAX's
swap_guided draws it from, sample_posterior=False. The JAX side of the end
-to-end check runs once for the module (its jit takes ~20 s here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import nchw, nhwc, random_tree
from test_torch_port_helpers import one_torch_thread

from reface_tpu.core.schedules import DDIMTables as JTables
from reface_tpu.core.schedules import DiffusionSchedule as JSchedule
from reface_tpu.diffusion import guidance as JG
from reface_tpu.diffusion.ddim_guided import guided_ddim_sample as j_guided
from reface_tpu.pipelines.swap import FaceSwapper as JSwapper
from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.core.schedules import DDIMTables as PTables
from reface_tpu_torch.core.schedules import DiffusionSchedule as PSchedule
from reface_tpu_torch.diffusion import guidance as PG
from reface_tpu_torch.diffusion.ddim_guided import guided_ddim_sample as p_guided
from reface_tpu_torch.pipelines.swap import FaceSwapper as PSwapper
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

_R = np.random.default_rng(21)
_WD = _R.normal(size=(4, 3)).astype(np.float32)
_WI = _R.normal(size=(48, 16)).astype(np.float32) / 4
_WS = _R.normal(size=(3, 19)).astype(np.float32)
_WE = _R.normal(size=(48, 64)).astype(np.float32) / 4
T = lambda a: torch.from_numpy(a)


# ------------------------------------------------ the toy towers, both packages

def _j_pool48(img):  # NHWC -> (B, 48): 4 x 4 mean pool, (y, x, c) order
    b, h, w, c = img.shape
    return img.reshape(b, 4, h // 4, 4, w // 4, c).mean(axis=(2, 4)).reshape(b, 48)


def _p_pool48(img):  # NCHW -> the same (B, 48)
    b, c, h, w = img.shape
    return img.reshape(b, c, 4, h // 4, 4, w // 4).mean(dim=(3, 5)).permute(0, 2, 3, 1) \
        .reshape(b, 48)


def j_decode(z):
    return jnp.tanh(jnp.repeat(jnp.repeat(z @ _WD, 4, axis=1), 4, axis=2))


def p_decode(z):
    img = torch.einsum("bchw,ck->bkhw", z, T(_WD))
    return torch.tanh(img.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3))


def j_embed(img):
    f = jnp.tanh(_j_pool48(img) @ _WI)
    return f / jnp.linalg.norm(f, axis=-1, keepdims=True)


def p_embed(img):
    f = torch.tanh(_p_pool48(img) @ T(_WI))
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


def j_seg(img):
    return 3.0 * jnp.tanh(img @ _WS)


def p_seg(img):
    return 3.0 * torch.tanh(torch.einsum("bchw,ck->bkhw", img, T(_WS)))


def j_exp(img01):
    return jnp.tanh(_j_pool48(img01) @ _WE)


def p_exp(img01):
    return torch.tanh(_p_pool48(img01) @ T(_WE))


def _toy_inputs(b=2, hw=4, seed=0):
    rng = np.random.default_rng(seed)
    s = 4 * hw
    return dict(
        pred=rng.normal(size=(b, hw, hw, 4)).astype(np.float32),
        source=rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        target=rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        region=(rng.uniform(size=(b, s, s, 1)) > 0.4).astype(np.float32),
    )


def _builders(x):
    """(JAX fn, port fn) of each builder on the toy towers."""
    jr, pr = jnp.asarray(x["region"]), nchw(x["region"])
    return {
        "id": (JG.make_id_guidance(j_decode, j_embed, jnp.asarray(x["source"]),
                                   inpaint_region=jr, weight=1.5),
               PG.make_id_guidance(p_decode, p_embed, nchw(x["source"]),
                                   inpaint_region=pr, weight=1.5)),
        "seg": (JG.make_seg_guidance(j_decode, j_seg, jnp.asarray(x["target"])),
                PG.make_seg_guidance(p_decode, p_seg, nchw(x["target"]))),
        "exp": (JG.make_expression_guidance(j_decode, j_exp, jnp.asarray(x["target"]),
                                            inpaint_region=jr),
                PG.make_expression_guidance(p_decode, p_exp, nchw(x["target"]),
                                            inpaint_region=pr)),
    }


def _port_value_and_grad(fn, pred_nhwc, t):
    x = nchw(pred_nhwc).requires_grad_(True)
    loss = fn(x, t)
    (g,) = torch.autograd.grad(loss, x)
    return loss.item(), nhwc(g)


@pytest.mark.parametrize("term,ts", [("id", (5, 6, 261, 499, 500)), ("seg", (261,)),
                                     ("exp", (261,))])
def test_builder_matches_jax_grad(term, ts):
    """Each builder's loss and its gradient with respect to pred_x0, against
    jax.grad of the JAX builder, the ID term at its gate's edges (5 and 500
    shut, 6 and 499 open). fp32 both sides: 1e-5 relative on the losses
    (up to ~100), 1e-5 absolute on the gradients."""
    x = _toy_inputs()
    jfn, pfn = _builders(x)[term]
    for t in ts:
        jl, jg = jax.value_and_grad(lambda p: jfn(p, t))(jnp.asarray(x["pred"]))
        pl, pg = _port_value_and_grad(pfn, x["pred"], t)
        np.testing.assert_allclose(pl, float(jl), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pg, np.asarray(jg), atol=1e-5, rtol=0)
        open_ = term != "id" or 5 < t < 500
        assert pfn.active(t) == open_
        assert (np.abs(pg).max() > 0) == open_


def test_one_decode_composition():
    """combine_guidance decodes pred_x0 once a step for the three terms and
    masks it once for the ID and expression terms: its loss and gradient
    equal the sum of the three terms each decoding on its own (1e-6), and
    the JAX combination's (1e-5); at t = 600 the ID term is shut, and the
    sum is the other two's."""
    x = _toy_inputs(seed=1)
    b = _builders(x)
    calls = []

    def counted(z):
        calls.append(1)
        return p_decode(z)

    for g in (b["id"][1], b["seg"][1], b["exp"][1]):
        g.decode_fn = counted
    combined = PG.combine_guidance(*(b[k][1] for k in ("id", "seg", "exp")))
    jcomb = JG.combine_guidance(*(b[k][0] for k in ("id", "seg", "exp")))
    for t, n_terms in ((261, 3), (600, 2)):
        calls.clear()
        pl, pg = _port_value_and_grad(combined, x["pred"], t)
        assert len(calls) == 1 and combined.active(t)
        calls.clear()
        sums = [_port_value_and_grad(b[k][1], x["pred"], t) for k in ("id", "seg", "exp")]
        assert len(calls) == n_terms
        np.testing.assert_allclose(pl, sum(s[0] for s in sums), rtol=1e-6)
        np.testing.assert_allclose(pg, sum(s[1] for s in sums), atol=1e-6, rtol=0)
        jl, jg = jax.value_and_grad(lambda p: jcomb(p, t))(jnp.asarray(x["pred"]))
        np.testing.assert_allclose(pl, float(jl), rtol=1e-5)
        np.testing.assert_allclose(pg, np.asarray(jg), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- the sampler

_WM = np.random.default_rng(9).normal(size=(9, 4)).astype(np.float32) / 3


def _j_model(x9, t, ctx):
    c = (t / 1000.0)[:, None, None, None] * ctx.mean(axis=(1, 2))[:, None, None, None]
    return jnp.tanh(x9 @ _WM + c)


def _p_model(x9, t, ctx):
    c = (t / 1000.0)[:, None, None, None] * ctx.mean(dim=(1, 2))[:, None, None, None]
    return torch.tanh(torch.einsum("bchw,ck->bkhw", x9, T(_WM)) + c)


def _p_dedup(x9, t, ctx2):
    return _p_model(torch.cat([x9, x9]), torch.cat([t, t]), ctx2)


@pytest.mark.parametrize("dedup", [False, True])
def test_guided_ddim_sample_matches_jax(dedup):
    """The guided chain on the toy eps model, 6 DDIM steps (t = 831, 665,
    499, 333, 167, 1), CFG 3 (the port's exact prefix dedup against JAX's
    batch doubling too), guidance scale 2 with the ID term on the toy
    towers: its gate opens at t = 499, 333 and 167 only, where the port
    decodes; elsewhere it adds nothing and JAX adds an exact zero. fp32:
    1e-5 absolute plus 1e-5 relative."""
    x = _toy_inputs(seed=2)
    rng = np.random.default_rng(4)
    b, hw = 2, 4
    x_T, z = (rng.normal(size=(b, hw, hw, 4)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(b, hw, hw, 1)) > 0.5).astype(np.float32)
    c, uc = (rng.normal(size=(b, 1, 8)).astype(np.float32) for _ in range(2))
    jfn, pfn = _builders(x)["id"]
    decodes = []
    pfn.decode_fn = lambda zz: decodes.append(1) or p_decode(zz)
    ref = j_guided(_j_model, jfn, *map(jnp.asarray, (x_T, c, uc, z, mask)),
                   JTables.create(JSchedule.create(), 6), 3.0, 2.0)
    got = p_guided(_p_model, pfn, nchw(x_T), T(c), T(uc), nchw(z), nchw(mask),
                   PTables.create(PSchedule.create(), 6), 3.0, 2.0,
                   dedup_model_fn=_p_dedup if dedup else None)
    assert len(decodes) == 3
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5, rtol=1e-5)
    unguided = p_guided(_p_model, pfn, nchw(x_T), T(c), T(uc), nchw(z), nchw(mask),
                        PTables.create(PSchedule.create(), 6), 3.0, 0.0)
    assert not np.allclose(nhwc(unguided), np.asarray(ref), atol=1e-3)


# ------------------------------------------------------------- swap_guided

def _swap_inputs(b=2, size=64, seed=0):
    rng = np.random.default_rng(seed)
    target = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    mask = np.ones((b, size, size, 1), np.float32)
    mask[:, size // 4: 3 * size // 4, size // 4: 3 * size // 4] = 0.0
    return dict(
        target_image=target,
        inpaint_image=target * mask,
        inpaint_mask=mask,
        ref_clip224=rng.normal(size=(b, 224, 224, 3)).astype(np.float32),
        landmarks=rng.uniform(0, size, (b, 136)).astype(np.float32),
    )


def _j_seg_logits(img):  # the JAX swap_guided hands NHWC images to its towers
    return j_seg(img)


@pytest.fixture(scope="module")
def swappers():
    """(JAX swapper, port swapper, inputs, x_T, JAX's guided output): the same
    random tiny towers in both, sample_posterior=False, 4 DDIM steps (t =
    751, 501, 251, 1: the ID gate opens at 251)."""
    jcfg = dataclasses.replace(j_tiny(64, 4), sample_posterior=False)
    pcfg = dataclasses.replace(p_tiny(64, 4), sample_posterior=False)
    shapes = jax.eval_shape(lambda k: JSwapper.init_params(jcfg, k), jax.random.key(0))
    params = {name: random_tree(tree, seed=i) for i, (name, tree) in enumerate(shapes.items())}
    inputs = _swap_inputs()
    key = jax.random.key(7)
    x_T = np.array(jax.random.normal(jax.random.split(key)[0], (2, 8, 8, 4), jnp.float32))
    jsw = JSwapper(jcfg, params)
    ref = np.asarray(jsw.swap_guided(**inputs, key=key, guidance=("id", "seg", "exp"),
                                     guidance_scale=1.0, seg_logits_fn=_j_seg_logits,
                                     exp_coeff_fn=j_exp))
    psw = PSwapper(pcfg, device="cpu", params={
        "unet": from_jax.unet_from_jax(params["unet"]),
        "vae": from_jax.vae_from_jax(params["vae"]),
        "conditioner": from_jax.conditioner_from_jax(params["conditioner"]),
    })
    return psw, inputs, x_T, ref


def test_swap_guided_matches_jax(swappers):
    """FaceSwapper.swap_guided with ("id", "seg", "exp") at guidance scale 1,
    called from inside torch.inference_mode (as RawSwapPipeline calls it),
    against JAX's with x_T from JAX's key split. ATOL 2e-4 on the [-1,1]
    images (fp32 both sides; summation order only)."""
    psw, inputs, x_T, ref = swappers
    with torch.inference_mode():
        got = psw.swap_guided(**{k: T(v) for k, v in inputs.items()}, x_T=T(x_T),
                              guidance=("id", "seg", "exp"), guidance_scale=1.0,
                              seg_logits_fn=p_seg, exp_coeff_fn=p_exp)
    assert got.shape == (2, 64, 64, 3) and torch.isfinite(got).all()
    assert (np.abs(ref) < 0.99).mean() > 0.5  # not saturated by the clamp
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=0)
    unguided = psw.swap(**inputs, x_T=x_T).numpy()
    assert np.abs(unguided - ref).max() > 1e-2  # the guidance moved the output


def test_scale_zero_equals_swap(swappers):
    """At guidance_scale 0 no gradient is taken: the ID-guided swap is
    FaceSwapper.swap on the same x_T, bit for bit (the same CFG path), and
    the same draws from the same generator without x_T."""
    psw, inputs, x_T, _ = swappers
    assert torch.equal(psw.swap_guided(**inputs, x_T=x_T, guidance_scale=0.0),
                       psw.swap(**inputs, x_T=x_T))
    gen = lambda: torch.Generator().manual_seed(5)
    assert torch.equal(psw.swap_guided(**inputs, generator=gen(), guidance_scale=0.0),
                       psw.swap(**inputs, generator=gen()))


def test_swap_guided_refuses(swappers):
    psw, inputs, x_T, _ = swappers
    with pytest.raises(ValueError, match="unknown guidance"):
        psw.swap_guided(**inputs, x_T=x_T, guidance=("id", "pose"))
    with pytest.raises(ValueError, match="seg_logits_fn"):
        psw.swap_guided(**inputs, x_T=x_T, guidance=("seg",))
