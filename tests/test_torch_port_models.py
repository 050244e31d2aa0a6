"""The port's towers against the JAX package's, at tiny widths, fp32, CPU.

Weights are random numpy leaves of the flax trees (no leaf zero, see
test_torch_port_helpers.random_tree) carried JAX -> port through
reface_tpu_torch.ckpt.from_jax, and the port's own state_dicts go
port -> JAX -> port through reface_tpu.ckpt.convert to prove the names are
the reference checkpoint's. The JAX towers run jitted: un-jitted flax
dispatches each op on its own, 12 s for one tiny UNet forward against 4 s
compiled. Tolerance: ROADMAP's ATOL 2e-4 (fp32 both sides, summation order
only).

The state-dict round trip through the reference converter and the dezero
init are in test_torch_port_models_ckpt.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import assert_close, init_jax, load, nchw, nhwc
from test_torch_port_helpers import one_torch_thread

from reface_tpu.nn import layers as JL
from reface_tpu.nn.arcface import IRSE50 as JIRSE50
from reface_tpu.nn.arcface import arcface_preprocess_from_clip as j_arc_pre
from reface_tpu.nn.clip import CLIPConditioner as JCLIP
from reface_tpu.nn.conditioner import REFaceConditioner as JCond
from reface_tpu.nn.unet import UNetConfig as JUNetConfig
from reface_tpu.nn.unet import UNetModel as JUNet
from reface_tpu.nn.vae import AutoencoderKL as JVAE
from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.nn import layers as PL
from reface_tpu_torch.nn.arcface import IRSE50 as PIRSE50
from reface_tpu_torch.nn.arcface import arcface_preprocess_from_clip as p_arc_pre
from reface_tpu_torch.nn.clip import CLIPConditioner as PCLIP
from reface_tpu_torch.nn.conditioner import REFaceConditioner as PCond
from reface_tpu_torch.nn.unet import UNetConfig as PUNetConfig
from reface_tpu_torch.nn.unet import UNetModel as PUNet
from reface_tpu_torch.nn.vae import AutoencoderKL as PVAE
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

JCFG, PCFG = j_tiny(64, 2), p_tiny(64, 2)
RNG = np.random.default_rng(0)


def _f32(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- layers

def _dense_sd(tree, names):
    sd = {}
    for flax_name, torch_name in names.items():
        sd[f"{torch_name}.weight"] = torch.from_numpy(tree[flax_name]["kernel"].T.copy())
        if "bias" in tree[flax_name]:
            sd[f"{torch_name}.bias"] = torch.from_numpy(tree[flax_name]["bias"])
    return sd


@pytest.mark.parametrize("ctx_shape", [None, (2, 5, 32), (2, 5, 64), (2, 1, 64),
                                       (2, 1, 32)])
def test_cross_attention_matches_jax(ctx_shape):
    """Self-attention (fused QKV), cross-attention with a plain and a split
    (2*context_dim) context, and the single-token shortcut of both."""
    x = _f32(2, 16, 64)
    ctx = None if ctx_shape is None else _f32(*ctx_shape)
    jm = JL.CrossAttention(64, context_dim=None if ctx is None else 32, heads=8,
                           dim_head=8, head_splits=(6, 2))
    args = (jnp.asarray(x),) if ctx is None else (jnp.asarray(x), jnp.asarray(ctx))
    params = init_jax(jm, *args)
    pm = PL.CrossAttention(64, context_dim=None if ctx is None else 32, heads=8,
                           dim_head=8, head_splits=(6, 2))
    names = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0"}
    load(pm, _dense_sd(params["params"], names))
    ref = jm.apply(params, *args)
    got = pm(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx))
    assert_close(got, ref)


def test_geglu_matches_jax():
    x = _f32(2, 16, 32)
    jm = JL.FeedForwardGEGLU(32)
    params = init_jax(jm, jnp.asarray(x))
    pm = load(PL.FeedForwardGEGLU(32),
               _dense_sd(params["params"], {"proj_in": "net.0.proj",
                                            "proj_out": "net.2"}))
    assert_close(pm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


# ---------------------------------------------------------------- UNet

def _unet_inputs(b=2, hw=8):
    return (_f32(b, hw, hw, 9), np.array([617, 3][:b], np.int32),
            _f32(2 * b, 1, 768))


def test_unet_matches_jax_plain_dedup_and_fused():
    """Tiny UNet against JAX; then, in the port, the cfg_expand prefix dedup
    against the batch-doubled call and fused_groupnorm=True against False
    (same weights). The end-to-end swap test holds the dedup path to JAX's."""
    x, t, ctx2 = _unet_inputs()
    jm = JUNet(JCFG.unet)
    params = init_jax(jm, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx2[:2]))
    sd = from_jax.unet_from_jax(params)
    pm = load(PUNet(PCFG.unet), sd)
    xt, tt, ct = nchw(x), torch.from_numpy(t), torch.from_numpy(ctx2)

    ref = jax.jit(jm.apply)(params, x, t, ctx2[:2])
    got = pm(xt, tt, ct[:2])
    assert float(np.abs(np.asarray(ref)).max()) > 1e-2  # not vacuous
    assert_close(nhwc(got), ref)

    # dedup vs doubled: same arithmetic on the same rows, only the batch
    # size of the products differs, so 1e-5
    got2 = pm(xt, tt, ct, cfg_expand=True)
    doubled = pm(torch.cat([xt, xt]), torch.cat([tt, tt]), ct)
    assert got2.shape == doubled.shape == (4, 4, 8, 8)
    assert_close(got2, doubled.numpy(), atol=1e-5)

    fused = load(PUNet(dataclasses.replace(PCFG.unet, fused_groupnorm=True)), sd)
    assert_close(fused(xt, tt, ct[:2]), got.numpy(), atol=1e-5)


@pytest.mark.slow
def test_unet_full_width_matches_jax():
    """The shipped width (model_channels=320, 859,535,364 params), fp32."""
    x, t, ctx2 = _unet_inputs(b=1)
    jm = JUNet(JUNetConfig(dtype=jnp.float32))
    params = init_jax(jm, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx2[:1]))
    pm = load(PUNet(PUNetConfig(dtype=torch.float32)), from_jax.unet_from_jax(params))
    assert sum(p.numel() for p in pm.parameters()) == 859_535_364
    ref = jax.jit(jm.apply)(params, x, t, ctx2[:1])
    got = pm(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx2[:1]))
    assert_close(nhwc(got), ref, atol=1e-3)


# ---------------------------------------------------------------- VAE

def test_vae_matches_jax():
    img = np.clip(_f32(2, 64, 64, 3, scale=0.5), -1, 1)
    jm = JVAE(JCFG.vae)
    params = init_jax(jm, jnp.asarray(img))
    pm = load(PVAE(PCFG.vae), from_jax.vae_from_jax(params))
    jpost = jax.jit(lambda p, a: jm.apply(p, a, method=JVAE.encode))(params, img)
    ppost = pm.encode(nchw(img))
    assert_close(nhwc(ppost.mean), jpost.mean)
    assert_close(nhwc(ppost.logvar), jpost.logvar)
    z = _f32(2, 8, 8, 4)
    ref = jax.jit(lambda p, a: jm.apply(p, a, method=JVAE.decode))(params, z)
    assert_close(nhwc(pm.decode(nchw(z))), ref)


# ------------------------------------------------------- conditioning towers

def test_clip_conditioner_matches_jax():
    x = _f32(2, 224, 224, 3)
    jm = JCLIP(JCFG.conditioner.clip)
    params = init_jax(jm, jnp.asarray(x))
    pm = load(PCLIP(PCFG.conditioner.clip), from_jax.clip_conditioner_from_jax(params))
    ref = jax.jit(jm.apply)(params, x)
    got = pm(nchw(x))
    assert got.shape == (2, 1, 768)
    assert_close(got, ref)


def test_arcface_matches_jax():
    clip_img = _f32(2, 224, 224, 3)
    ref_in = j_arc_pre(jnp.asarray(clip_img))
    got_in = p_arc_pre(nchw(clip_img))
    assert_close(nhwc(got_in), ref_in, atol=1e-5)
    jm = JIRSE50(JCFG.conditioner.arcface)
    params = init_jax(jm, ref_in)
    pm = load(PIRSE50(PCFG.conditioner.arcface), from_jax.arcface_from_jax(params))
    assert_close(pm(got_in), jax.jit(jm.apply)(params, ref_in))


def _cond_inputs():
    return (_f32(2, 224, 224, 3), _f32(2, 224, 224, 3),
            RNG.uniform(0, 512, (2, 136)).astype(np.float32))


def test_conditioner_matches_jax():
    ref224, tar224, lm = _cond_inputs()
    jm = JCond(JCFG.conditioner)
    params = init_jax(jm, *map(jnp.asarray, (ref224, tar224, lm)))
    pm = load(PCond(PCFG.conditioner), from_jax.conditioner_from_jax(params))
    ref = jax.jit(jm.apply)(params, ref224, tar224, lm)
    got = pm(nchw(ref224), nchw(tar224), torch.from_numpy(lm))
    assert_close(got, ref)
    uc = jm.apply(params, 3, method=JCond.null_conditioning)
    assert_close(pm.null_conditioning(3), uc, atol=0)


# ------------------------------------------------------- names = checkpoint's
