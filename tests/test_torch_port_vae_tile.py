"""An all-zero VAE encode tile (ROADMAP C2): its cause, and the port held to
the jitted JAX encode at the standard mask hole.

The standard hole [16:48) of a 64 px input fills the centre 32 px encode
tile of the tiled VAE (vae_tile=4, stride 2) with zeros. On zeros, the
encoder's conv_in gives each channel its bias everywhere, so each group of
the first GroupNorm (encoder.down.0.block.0.norm1) is constant: at the tiny
width (16 channels, one per group) its variance is 0 against eps = 1e-6,
and rsqrt(var + eps) = 1e3 multiplies the rounding noise of the group mean.
The next norm (norm2) sees groups of variance ~2.5e-6, another x ~540. A
1e-7 change of the input moves the jitted JAX encode of that tile by ~7e-2,
and the JAX package's own eager and jitted encodes differ by up to 1.9e-2
there, 1.5e-3 after the fold. At full width (128 channels, 4 per group) a group
holds 4 distinct biases, so the tile is not ill-conditioned there
(chip_smoke.py phase 9 compares a bf16 all-zero tile with fp32).

The port computes the constant group's mean exactly (deviation 0), where
each JAX program carries its own rounding noise, so the port is a third
point of the same scatter, not a point between the two JAX ones. After the
fold, over the VAE weight seeds 1, 2 and 3 (the input outside the hole does
not move these numbers), the JAX eager encode is 0.56e-3, 1.52e-3 and
0.67e-3 from the jitted one, and the port 1.66e-3, 2.25e-3 and 2.36e-3: the
tolerance is twice the JAX package's largest eager-against-jit spread,
3e-3, on latents of scale 0.3-0.5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import nchw, nhwc, random_tree
from test_torch_port_helpers import one_torch_thread

from reface_tpu.nn.vae import AutoencoderKL as JVAE
from reface_tpu.pipelines.swap import FaceSwapper as JSwapper
from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.nn.layers import GroupNorm32
from reface_tpu_torch.nn.vae import AutoencoderKL as PVAE
from reface_tpu_torch.pipelines.swap import SwapModules
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

ZERO_TILE_TOL = 3e-3  # 2x the JAX eager-vs-jit spread after the fold (docstring)
TILES = dict(vae_tile=4, vae_tile_stride=2, sample_posterior=False)
JCFG = dataclasses.replace(j_tiny(64, 2), **TILES)
PCFG = dataclasses.replace(p_tiny(64, 2), **TILES)


def _vae_params():
    shapes = jax.eval_shape(lambda k: JSwapper.init_params(JCFG, k), jax.random.key(0))
    return random_tree(shapes["vae"], seed=1)


def test_zero_tile_encode_matches_the_jitted_jax_encode():
    """The tiled encode of a target whose [16:48) hole is zero: port against
    the jitted JAX encode within ZERO_TILE_TOL; the JAX package's own eager
    and jitted encodes disagree there too."""
    params = _vae_params()
    rng = np.random.default_rng(0)
    mask = np.ones((2, 64, 64, 1), np.float32)
    mask[:, 16:48, 16:48] = 0.0
    image = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) * mask
    js = JSwapper(JCFG, {"vae": params})
    enc = lambda p, x: js.encode_latent({"vae": p}, x)
    jit = np.asarray(jax.jit(enc)(params, jnp.asarray(image)))
    eager = np.asarray(enc(params, jnp.asarray(image)))
    spread = np.abs(eager - jit).max()
    assert spread > 1e-4  # the JAX package's own programs disagree here
    modules = SwapModules(PCFG, device="cpu")
    modules.vae.load_state_dict(from_jax.vae_from_jax(params))
    with torch.no_grad():
        got = nhwc(modules.encode_latent(nchw(image)))
    assert np.isfinite(got).all() and got.shape == jit.shape == (2, 8, 8, 4)
    assert np.abs(got - jit).max() <= ZERO_TILE_TOL, (np.abs(got - jit).max(), spread)


def test_zero_tile_is_ill_conditioned_at_the_first_groupnorm():
    """On an all-zero tile the first GroupNorm's groups are constant
    (variance 0 in the port), and 1e-7 of input noise moves the jitted JAX
    encode by more than 1e-2, against less than 1e-4 on a random tile."""
    params = _vae_params()
    vae = JVAE(JCFG.vae)
    enc = jax.jit(lambda x: vae.apply(params, x, method=JVAE.encode).mode())
    rng = np.random.default_rng(1)
    noise = rng.normal(0, 1e-7, (1, 32, 32, 3)).astype(np.float32)
    zero = np.zeros((1, 32, 32, 3), np.float32)
    tile = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    moved = lambda x: np.abs(np.asarray(enc(x + noise)) - np.asarray(enc(x))).max()
    assert moved(zero) > 1e-2 and moved(tile) < 1e-4
    pv = PVAE(PCFG.vae, device="cpu").eval()
    pv.load_state_dict(from_jax.vae_from_jax(params))
    seen = {}

    def hook(name):
        def fn(module, inputs, out):
            x = inputs[0].double()
            seen[name] = x.reshape(x.shape[0], module.groups, -1).var(dim=2).min().item()
        return fn

    for name, m in pv.named_modules():
        if isinstance(m, GroupNorm32):
            m.register_forward_hook(hook(name))
    with torch.no_grad():
        pv.encode(nchw(zero))
    assert seen["encoder.down.0.block.0.norm1"] == 0.0
    assert seen["encoder.down.0.block.0.norm2"] < 1e-5
    assert all(v > 1e-3 for k, v in seen.items() if not k.startswith("encoder.down.0."))
