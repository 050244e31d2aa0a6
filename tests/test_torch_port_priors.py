"""The port's priors (reface_tpu_torch/preprocess/tps.py, preprocess/priors.py)
and the resizes they use, against the JAX package's, fp32, on the CPU.

The same numpy inputs go through both packages. DIFT's argmax is held with a
feature function whose lattice cells are well separated (each source cell a
target cell's feature, permuted, beside unrelated cells), so that the index
must agree exactly: a near-tie could flip between the packages' summation
orders. make_unet_feats_fn runs on tiny_swap_config(64) with a third UNet
level, so that the latent/4 tap exists, and takes the JAX package's noise
draws as given noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import nchw, nhwc, random_tree
from test_torch_port_helpers import one_torch_thread

from reface_tpu.preprocess import priors as JP
from reface_tpu.preprocess import tps as JT
from reface_tpu_torch.preprocess import priors as PP
from reface_tpu_torch.preprocess import tps as PT
from reface_tpu_torch.ops.resize import resize_bilinear_aa, resize_nearest

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

T = lambda a: torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("src,out,method", [
    (512, 256, "bilinear"),  # BiSeNet's input in cli.swap --guidance seg
    (512, 224, "bilinear"),  # D3DFR's input in cli.swap --guidance exp
    (16, 128, "bilinear"),   # DIFT's feature lattice, enlarged
    (128, 500, "nearest"),   # DIFT's field at a ratio that is not whole
])
def test_resizes_match_jax_image_resize(src, out, method):
    """jax.image.resize's bilinear antialiases when it shrinks and is the
    half-pixel lerp when it enlarges (resize_bilinear_aa both ways, 1e-6);
    its nearest is resize_nearest's pixels, exactly."""
    x = np.random.default_rng(src + out).uniform(-1, 1, (1, src, src, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, out, out, 3), method))
    fn = resize_bilinear_aa if method == "bilinear" else resize_nearest
    got = nhwc(fn(nchw(x), out, out))
    if method == "nearest":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _control_points(seed, n=68, jitter=0.05):
    """n points on a jittered lattice in [-0.9, 0.9] (a regular L matrix),
    and targets moved from them."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    g = np.stack(np.meshgrid(np.linspace(-0.9, 0.9, side), np.linspace(-0.9, 0.9, side)),
                 -1).reshape(-1, 2)[:n]
    x = (g + rng.uniform(-jitter, jitter, g.shape)).astype(np.float32)
    y = (x + rng.uniform(-0.1, 0.1, x.shape)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("n,tol", [(9, 1e-5), (68, 5e-5)])
def test_tps_matches_jax(n, tol):
    """tps_coefs, tps_warp and tps_grid. 9 control points: 1e-5. 68 (the
    landmark prior's): the (p+3) L matrix is ill-conditioned enough that
    both packages' fp32 solves land ~1e-5 from the float64 solution (seen:
    JAX 1.16e-5, the port 8.1e-6 on the warp; 1.28e-5 apart; the weights
    ~1e-4 apart at a scale of 2.7), so the warps are held within 5e-5 of
    JAX's and the weights within 2e-4, and the port's warp no further from
    the float64 one than JAX's is, with a margin of 1.5x."""
    x, y = _control_points(n, n)
    pts = np.random.default_rng(3).uniform(-1, 1, (300, 2)).astype(np.float32)
    for got, ref in zip(PT.tps_coefs(T(x), T(y)), JT.tps_coefs(jnp.asarray(x), jnp.asarray(y))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=4 * tol, rtol=0)
    got, ref = PT.tps_warp(T(x), T(y), T(pts)).numpy(), np.asarray(JT.tps_warp(x, y, pts))
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    exact = PT.tps_warp(*(T(a).double() for a in (x, y, pts))).numpy()
    assert np.abs(got - exact).max() <= 1.5 * max(np.abs(ref - exact).max(), 1e-6)
    np.testing.assert_allclose(PT.tps_grid(T(x), T(y), 24, 40).numpy(),
                               np.asarray(JT.tps_grid(x, y, 24, 40)), atol=tol, rtol=0)


def test_grid_sample_matches_jax():
    """grid_sample_2d (torch's grid_sampler_2d: bilinear, zeros outside,
    align_corners=False) against the JAX gather-lerp, the grid reaching
    past the image on every side, 1e-5."""
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (2, 20, 28, 3)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 17, 13, 2)).astype(np.float32)
    ref = np.asarray(JT.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid)))
    got = nhwc(PT.grid_sample_2d(nchw(img), T(grid)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_landmark_tps_prior_matches_jax():
    """The 68-landmark TPS prior: the source warped onto the target's
    landmarks and pasted inside the face mask; outside the mask it is the
    target, exactly. The warp carries the 68-point solve's fp32 error
    (test_tps_matches_jax: ~1e-5 of the [-1, 1] range, ~2.4e-4 px here) into
    a noise image whose neighbouring pixels differ by up to 2: seen 3.2e-4
    between the packages, so 1e-3, and the port no further from the float64
    prior than JAX is, with a margin of 1.5x."""
    rng = np.random.default_rng(6)
    h = w = 48
    tgt, src = (rng.uniform(-1, 1, (h, w, 3)).astype(np.float32) for _ in range(2))
    x, y = _control_points(7)
    t_lm, s_lm = ((p + 1) * w / 2 - 0.5 for p in (x, y))
    mask = (rng.uniform(size=(h, w, 1)) > 0.3).astype(np.float32)
    args = (tgt, src, t_lm, s_lm, mask)
    ref = np.asarray(JP.landmark_tps_prior(*map(jnp.asarray, args)))
    got = PP.landmark_tps_prior(*map(T, args)).numpy()
    exact = PP.landmark_tps_prior(*(T(a).double() for a in args)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    assert np.abs(got - exact).max() <= 1.5 * np.abs(ref - exact).max()
    np.testing.assert_array_equal(got[mask[..., 0] == 0], tgt[mask[..., 0] == 0])


def _separated_feats(grid, c, seed):
    """(target, source) features at the lattice's own size (the resize an
    identity): unit vectors in c dims; each source cell is a random target
    cell's feature plus noise, or (every 7th) an unrelated vector."""
    rng = np.random.default_rng(seed)
    ft = rng.normal(size=(grid * grid, c))
    ft /= np.linalg.norm(ft, axis=-1, keepdims=True)
    perm = rng.permutation(grid * grid)
    fs = ft[perm] + 0.05 * rng.normal(size=ft.shape)
    fs[::7] = rng.normal(size=fs[::7].shape)
    fs /= np.linalg.norm(fs, axis=-1, keepdims=True)
    shape = (grid, grid, c)
    return ft.reshape(shape).astype(np.float32), fs.reshape(shape).astype(np.float32)


@pytest.mark.parametrize("size", [64, 50])
def test_dift_prior_matches_jax(size):
    """dift_prior on well-separated features, grid 16: the same correspondence
    index, cell for cell, and the prior image within 1e-5 (the field nearest-
    enlarged 16 -> 64, and 16 -> 50 at a ratio that is not whole)."""
    grid = 16
    ft, fs = _separated_feats(grid, 64, size)
    rng = np.random.default_rng(size)
    tgt, src = (rng.uniform(-1, 1, (size, size, 3)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(size, size, 1)) > 0.3).astype(np.float32)

    def feats(lib):
        it = iter((ft, fs))
        return lambda img: (jnp.asarray if lib == "jax" else T)(next(it))

    ref = np.asarray(JP.dift_prior(*map(jnp.asarray, (tgt, src, mask)), feats("jax"), grid))
    got = PP.dift_prior(*map(T, (tgt, src, mask)), feats("torch"), grid).numpy()
    idx = PP.dift_index(T(ft), T(fs), grid).numpy()
    sims = ft.reshape(grid * grid, -1) @ fs.reshape(grid * grid, -1).T
    np.testing.assert_array_equal(idx, np.argmax(sims, axis=1))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_make_unet_feats_fn_matches_jax():
    """The DIFT extractor on tiny_swap_config(64) with channel_mult (1, 2, 2)
    (latent 8, tap at 2 x 2): the encode's mode, q_sample at t = 261, [z_t,
    z, ones], the null conditioning, an ensemble of draws averaged (2 here:
    the JAX jit unrolls one UNet forward a draw, ~4 s each). The JAX draws
    (key seed * 1000 + e) are given to the port. fp32, 2e-4."""
    from reface_tpu.pipelines.swap import FaceSwapper as JSwapper
    from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
    from reface_tpu_torch.ckpt import from_jax
    from reface_tpu_torch.pipelines.swap import FaceSwapper as PSwapper
    from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

    def three_levels(cfg):
        return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, channel_mult=(1, 2, 2)))

    jcfg, pcfg = three_levels(j_tiny(64)), three_levels(p_tiny(64))
    shapes = jax.eval_shape(lambda k: JSwapper.init_params(jcfg, k), jax.random.key(0))
    params = {name: random_tree(tree, seed=10 + i) for i, (name, tree) in enumerate(shapes.items())}
    img = np.random.default_rng(8).uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    seed = 3
    jfn = JP.make_unet_feats_fn(JSwapper(jcfg, params), params, ensemble=2, seed=seed)
    ref = np.asarray(jax.jit(jfn)(jnp.asarray(img)))
    noises = [nchw(np.asarray(jax.random.normal(jax.random.key(seed * 1000 + e), (1, 8, 8, 4))))
              for e in range(2)]
    port = PSwapper(pcfg, device="cpu", params={
        "unet": from_jax.unet_from_jax(params["unet"]),
        "vae": from_jax.vae_from_jax(params["vae"]),
        "conditioner": from_jax.conditioner_from_jax(params["conditioner"]),
    })
    got = PP.make_unet_feats_fn(port, ensemble=2, seed=seed, noises=noises)(T(img)).numpy()
    assert ref.shape == got.shape == (2, 2, 64)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    drawn = PP.make_unet_feats_fn(port, seed=seed)(T(img))
    assert drawn.shape == (2, 2, 64) and torch.isfinite(drawn).all()
