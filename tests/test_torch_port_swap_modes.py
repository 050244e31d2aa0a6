"""The port's int8 serving modes and its serving modes end to end, against
the JAX package, fp32, CPU.

The int8 products (ops/quant.py) take the same inputs as
reface_tpu.ops.quant: the int8 operands and the int32 accumulators are
then equal, and the dequantised outputs within 1e-6 relative (the same
fp32 operations). The towers with quant on run with weights carried
through reface_tpu_torch.ckpt.from_jax, whose converters serve every mode:
the quant modes leave the parameters and their names as they are. A whole
int8 forward cannot be held to the JAX one tightly: the float layers leave
the two packages' activations some ulps apart, and where x / scale lies
within those ulps of a half the two round to int8 values one apart; at
the random tiny widths the jump carries on through every later site, and
the two outputs end about as far apart as int8 is from fp32. So the
towers are held site by site: every int8 product of
the JAX forward is fed, on its own input, to the port layer with the same
weight, and the outputs agree to 1e-6 (_check_sites). The tiny swaps run
as test_torch_port_swap.py's (tiny_swap_config(64, 2),
sample_posterior=False, a fixed x_T).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import assert_close, init_jax, load, nchw, nhwc, random_tree
from test_torch_port_helpers import one_torch_thread
from test_torch_port_swap import _inputs

from reface_tpu.nn.clip import CLIPConditioner as JCLIP
from reface_tpu.nn.unet import UNetModel as JUNet
from reface_tpu.nn.vae import AutoencoderKL as JVAE
from reface_tpu.ops import quant as JQ
from reface_tpu.pipelines.swap import FaceSwapper as JSwapper
from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.nn.clip import CLIPConditioner as PCLIP
from reface_tpu_torch.nn.unet import UNetModel as PUNet
from reface_tpu_torch.nn.vae import AutoencoderKL as PVAE
from reface_tpu_torch.ops import quant as PQ
from reface_tpu_torch.pipelines.swap import FaceSwapper as PSwapper
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

rp = dataclasses.replace
RNG = np.random.default_rng(0)


def _f32(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _quant(cfg, unet="none", vae="none", clip="none"):
    """A swap config with the towers' quant modes set."""
    cond = cfg.conditioner
    return rp(cfg, unet=rp(cfg.unet, quant=unet), vae=rp(cfg.vae, quant=vae),
              conditioner=rp(cond, clip=rp(cond.clip, quant=clip)))


def test_new_modules_import_no_jax():
    """The modules of the serving modes import neither jax nor reface_tpu
    (fresh interpreter)."""
    code = (
        "import sys\n"
        "import reface_tpu_torch.diffusion.plms, reface_tpu_torch.diffusion.dpm_solver, "
        "reface_tpu_torch.parallel.tiling, reface_tpu_torch.ops.quant, "
        "reface_tpu_torch.pipelines.swap\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'reface_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_int8_products_match_jax():
    """quant_int8, int8_dense (per-row activation scales) and int8_conv
    (per-sample scales; 3x3 with padding 1 and 1x1 with padding 0) on the
    same inputs: the int8 operands and the int32 accumulators equal, the
    outputs within 1e-6 relative. The port's layouts: a Linear's (N, K)
    weight, a Conv2d's (O, I, kh, kw), NCHW activations."""
    w = _f32(48, 24)  # JAX (K, N)
    jq, js = JQ.quant_int8(jnp.asarray(w), axis=0)
    pq, ps = PQ.quant_int8(torch.from_numpy(w.T.copy()), dim=1)
    np.testing.assert_array_equal(pq.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy().T, np.asarray(js))
    # a row with outliers and a half-way value: round half to even
    x = _f32(3, 5, 48)
    x[0, 0, 0] = 40.0
    x[1, 2, :] = 0.0  # an all-zero row: the 1e-8 floor of the scale
    ref = JQ.int8_dense(jnp.asarray(x), jnp.asarray(w))
    got = PQ.int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    xq, _ = PQ.quant_rows(torch.from_numpy(x), -1)
    wq, _ = PQ.quant_int8(torch.from_numpy(w.T.copy()), dim=1)
    acc = PQ.int_mm(xq.reshape(-1, 48), wq)
    j_xq = np.clip(np.round(x / (np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8)
                                 / np.float32(127.0))), -127, 127).astype(np.int64)
    np.testing.assert_array_equal(xq.numpy(), j_xq)
    np.testing.assert_array_equal(acc.numpy(), j_xq.reshape(-1, 48) @ pq.numpy().T.astype(np.int64))
    np.testing.assert_array_equal(PQ.int_mm_plain(xq.reshape(-1, 48), wq), acc)
    for k, pad in ((3, 1), (1, 0)):
        xc = _f32(2, 7, 9, 16)
        wc = _f32(k, k, 16, 24)  # HWIO
        ref = JQ.int8_conv(jnp.asarray(xc), jnp.asarray(wc), padding=[(pad, pad)] * 2)
        got = PQ.int8_conv(nchw(xc), torch.from_numpy(wc.transpose(3, 2, 0, 1).copy()), pad)
        assert got.shape == (2, 24, 7, 9)
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=1e-6, atol=0)


@pytest.fixture
def jax_int8_calls(monkeypatch):
    """Records every int8 product of the JAX package's forwards, jitted or
    not: (x, w, out) as numpy, through jax.debug.callback. The JAX layers
    import int8_dense / int8_conv from reface_tpu.ops.quant at each call,
    so the wrappers set here are what they run."""
    calls = []
    dense, conv = JQ.int8_dense, JQ.int8_conv

    def record(kind, x, w, out):
        jax.debug.callback(lambda *a: calls.append((kind, *map(np.asarray, a))), x, w, out)
        return out

    monkeypatch.setattr(JQ, "int8_dense", lambda x, w, **kw: record(
        "dense", x, w, dense(x, w, **kw)))
    monkeypatch.setattr(JQ, "int8_conv", lambda x, w, **kw: record(
        "conv", x, w, conv(x, w, **kw)))
    return calls


def _check_sites(calls, port):
    """Every int8 product the JAX forward ran, fed to the port's layer with
    the same weight (from_jax), on the JAX layer's own input: the same
    output to 1e-6 relative (bias added as the JAX QDense/QConv add it;
    the JAX self-attention's one product against the concatenated q/k/v
    weight is the port's to_q, to_k, to_v). And each int8 layer of the
    port is one of them: the same sites are quantised in both packages.
    Returns the number of products checked."""
    int8 = {id(m): m for m in port.modules() if getattr(m, "int8", False)}
    by_weight = {}
    for m in int8.values():
        by_weight.setdefault(m.weight.detach().numpy().tobytes(), []).append(m)
    seen = set()
    for kind, x, w, out in calls:
        if kind == "dense":  # (K, N); the fused q/k/v is three port layers
            whole = by_weight.get(np.ascontiguousarray(w.T).tobytes())
            parts = [w] if whole else np.split(w, 3, axis=1)
            layers = [by_weight.get(np.ascontiguousarray(p.T).tobytes()) for p in parts]
        else:  # HWIO
            layers = [by_weight.get(np.ascontiguousarray(w.transpose(3, 2, 0, 1)).tobytes())]
        assert all(la is not None and len(la) == 1 for la in layers), (kind, w.shape)
        layers = [la[0] for la in layers]
        seen.update(id(la) for la in layers)
        with torch.no_grad():
            if kind == "dense":
                got = torch.cat([la(torch.from_numpy(x.copy())) for la in layers], -1).numpy()
            else:
                got = nhwc(layers[0](nchw(x)))
        bias = np.concatenate([np.zeros(la.weight.shape[0], np.float32) if la.bias is None
                               else la.bias.detach().numpy() for la in layers])
        np.testing.assert_allclose(got, out + bias, rtol=1e-6, atol=1e-6 * np.abs(out).max())
    assert seen == set(int8), f"{len(set(int8) - seen)} int8 layers of the port never ran in JAX"
    return len(calls)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _check_noise(port_q, port_plain, jax_q, jax_plain):
    """The whole int8 forward: finite, and as far from the plain forward as
    the JAX package's int8 forward is from its plain one, within a factor 2
    (one boundary that falls apart between the packages carries on through
    every later site, so the two int8 outputs are not compared directly;
    the plain ones agree within ROADMAP's 2e-4)."""
    port_q, port_plain = (np.asarray(torch.as_tensor(a)) for a in (port_q, port_plain))
    assert np.isfinite(port_q).all()
    assert_close(port_plain, jax_plain)
    ratio = _rel(port_q, port_plain) / _rel(jax_q, jax_plain)
    assert 0.5 <= ratio <= 2.0, ratio


@pytest.mark.parametrize("quant", ["int8", "int8conv"])
def test_unet_int8_matches_jax(quant, jax_int8_calls):
    """The tiny UNet with quant on, the JAX UNet's int8 products site by
    site (_check_sites): "int8" quantises the ResBlock convs and the
    self-attention and GEGLU products, "int8conv" the convs only; the stem,
    head, resampling, proj_in/proj_out, time embedding and cross-attention
    stay plain in both."""
    x, t, ctx = _f32(2, 8, 8, 9), np.array([617, 3], np.int32), _f32(2, 1, 768)
    jcfg, pcfg = j_tiny(64, 2).unet, p_tiny(64, 2).unet
    params = init_jax(JUNet(jcfg), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    sd = from_jax.unet_from_jax(params)
    pm = load(PUNet(rp(pcfg, quant=quant)), sd)
    jm = JUNet(rp(jcfg, quant=quant))
    ref = jax.jit(lambda p, *a: jm.apply(p, *a))(params, x, t, ctx)
    jax.effects_barrier()
    # 12 ResBlocks: 24 convs and 7 shortcuts; 11 TransformerBlocks: the
    # fused q/k/v, to_out and the two GEGLU products
    assert _check_sites(jax_int8_calls, pm) == (31 + 44 if quant == "int8" else 31)
    xt, tt, ct = nchw(x), torch.from_numpy(t), torch.from_numpy(ctx)
    jplain = jax.jit(lambda p, *a: JUNet(jcfg).apply(p, *a))(params, x, t, ctx)
    _check_noise(nhwc(pm(xt, tt, ct)), nhwc(load(PUNet(pcfg), sd)(xt, tt, ct)), ref, jplain)


def test_vae_int8_matches_jax(jax_int8_calls):
    """The tiny VAE with quant="int8" (its ResnetBlocks' conv1, conv2 and
    nin_shortcut; attention, stem, head and resampling plain): the JAX
    encode's and decode's int8 products site by site."""
    img = np.clip(_f32(2, 64, 64, 3, scale=0.5), -1, 1)
    jcfg, pcfg = j_tiny(64, 2).vae, p_tiny(64, 2).vae
    params = init_jax(JVAE(jcfg), jnp.asarray(img))
    sd = from_jax.vae_from_jax(params)
    pm, plain = load(PVAE(rp(pcfg, quant="int8")), sd), load(PVAE(pcfg), sd)
    jm = JVAE(rp(jcfg, quant="int8"))
    z = _f32(2, 8, 8, 4)
    enc = lambda m: jax.jit(lambda p, a: m.apply(p, a, method=JVAE.encode).mean)
    dec = lambda m: jax.jit(lambda p, a: m.apply(p, a, method=JVAE.decode))
    jmean, jimg = enc(jm)(params, img), dec(jm)(params, z)
    jax.effects_barrier()
    # encode: 6 ResnetBlocks, 1 shortcut; decode: 10 ResnetBlocks, 1 shortcut
    assert _check_sites(jax_int8_calls, pm) == 12 + 1 + 20 + 1
    _check_noise(nhwc(pm.encode(nchw(img)).mean), nhwc(plain.encode(nchw(img)).mean),
                 jmean, enc(JVAE(jcfg))(params, img))
    _check_noise(nhwc(pm.decode(nchw(z))), nhwc(plain.decode(nchw(z))),
                 jimg, dec(JVAE(jcfg))(params, z))


def test_clip_int8_matches_jax(jax_int8_calls):
    """The tiny CLIP conditioner with quant="int8" (--quant-cond: every
    layer's q/k/v/out and MLP products; the patch embedding, projection
    and mapper plain): the JAX tower's int8 products site by site."""
    x = _f32(2, 224, 224, 3)
    jcfg, pcfg = j_tiny(64, 2).conditioner.clip, p_tiny(64, 2).conditioner.clip
    params = init_jax(JCLIP(jcfg), jnp.asarray(x))
    sd = from_jax.clip_conditioner_from_jax(params)
    pm, plain = load(PCLIP(rp(pcfg, quant="int8")), sd), load(PCLIP(pcfg), sd)
    jm = JCLIP(rp(jcfg, quant="int8"))
    ref = jax.jit(lambda p, a: jm.apply(p, a))(params, x)
    jax.effects_barrier()
    assert _check_sites(jax_int8_calls, pm) == 6  # q, k, v, out, fc1, fc2
    _check_noise(pm(nchw(x)), plain(nchw(x)), ref,
                 jax.jit(lambda p, a: JCLIP(jcfg).apply(p, a))(params, x))


def test_quant_modes_keep_the_parameters():
    """Every quant mode has the plain towers' state_dict keys and shapes,
    so the one converter (and a reference checkpoint) serves them all."""
    base = p_tiny(64, 2)
    plain = PSwapper(base, device="cpu")
    for mode in ("int8", "int8conv"):
        q = PSwapper(_quant(base, mode, mode, "int8"), device="cpu")
        for name, module in q.towers().items():
            want = plain.towers()[name].state_dict()
            got = module.state_dict()
            assert list(got) == list(want)
            assert all(got[k].shape == want[k].shape for k in want)
        q.load_params({n: m.state_dict() for n, m in plain.towers().items()})


# ------------------------------------------------------------ end to end

_JTINY, _PTINY = j_tiny(64, 2), p_tiny(64, 2)
_MODES = {  # the change to both packages' tiny configs
    "plms": dict(sampler="plms"),
    "dpm_lam_uniform": dict(sampler="dpm", ddim_discretize="lam_uniform"),
    "tiles": dict(vae_tile=4, vae_tile_stride=2, unet_tile=4, unet_tile_stride=2),
    "int8": dict(),  # _quant(..., "int8", "int8", "int8")
}


@pytest.fixture(scope="module")
def swap_params():
    shapes = jax.eval_shape(lambda k: JSwapper.init_params(_JTINY, k), jax.random.key(0))
    params = {name: random_tree(tree, seed=i) for i, (name, tree) in enumerate(shapes.items())}
    port = {"unet": from_jax.unet_from_jax(params["unet"]),
            "vae": from_jax.vae_from_jax(params["vae"]),
            "conditioner": from_jax.conditioner_from_jax(params["conditioner"])}
    return params, port


@pytest.mark.parametrize("mode", list(_MODES))
def test_swap_mode_matches_jax(mode, swap_params, jax_int8_calls):
    """FaceSwapper.swap in each serving mode against the JAX swap, 2 steps,
    1e-4 on the images as test_swap_matches_jax: PLMS with CFG;
    DPM-Solver++(2M) on the lam_uniform grid with the dedup; the VAE and
    the UNet on 4-latent tiles at stride 2 (9 tiles; the encode's at 32
    px); --quant int8 --quant-cond (UNet, VAE and CLIP "int8").

    tiles: the mask's hole is [20:44) here, not [16:48): that hole fills the
    centre 32 px encode tile exactly, and the VAE encoder on an all-zero
    image is ill-conditioned (the JAX package's own eager and jitted
    encodes of that tile differ by 1.9e-2, and by 1.5e-3 after the fold).
    int8: the images are not compared (see the module docstring); every
    int8 product of the JAX swap (the conditioning, both VAE passes, each
    UNet forward of the chain) is reproduced site by site, and the port's
    int8 swap is as far from its plain swap as the JAX package's are."""
    params, port = swap_params
    if mode == "int8":
        jcfg, pcfg = (_quant(c, "int8", "int8", "int8") for c in (_JTINY, _PTINY))
    else:
        jcfg, pcfg = (rp(c, **_MODES[mode]) for c in (_JTINY, _PTINY))
    jcfg, pcfg = (rp(c, sample_posterior=False) for c in (jcfg, pcfg))
    inputs = _inputs()
    if mode == "tiles":
        mask = np.ones_like(inputs["inpaint_mask"])
        mask[:, 20:44, 20:44] = 0.0
        inputs.update(inpaint_mask=mask, inpaint_image=inputs["target_image"] * mask)
    ref = np.asarray(JSwapper(jcfg, params).swap(**inputs))
    jax.effects_barrier()
    swapper = PSwapper(pcfg, device="cpu", params=port)
    got = swapper.swap(**inputs)
    assert got.shape == (2, 64, 64, 3) and torch.isfinite(got).all()
    assert (np.abs(ref) < 0.99).mean() > 0.5  # not saturated by the clamp
    if mode != "int8":
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
        return
    # CLIP 6, encode 13, decode 21, 2 dedup UNet forwards of 75
    assert _check_sites(jax_int8_calls, torch.nn.ModuleList(swapper.towers().values())) \
        == 6 + 13 + 21 + 2 * 75
    plain = lambda c: rp(c, sample_posterior=False)
    _check_noise(got.numpy(), PSwapper(plain(_PTINY), device="cpu", params=port)
                 .swap(**inputs).numpy(), ref,
                 np.asarray(JSwapper(plain(_JTINY), params).swap(**inputs)))
