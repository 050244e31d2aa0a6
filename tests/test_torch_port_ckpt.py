"""The port's checkpoint reader (reface_tpu_torch/ckpt/from_torch.py) and the
converter of JAX-trained parameters (scripts/jax_params_to_torch.py),
against the JAX package's converters on the same torch files.

A tiny REFace `last.ckpt` is laid out from port state dicts under the
reference's prefixes, with LitEma's `model_ema.*` entries, `global_step`,
`optimizer_states` and `hyper_parameters` beside the state dict, and saved
with torch.save. The reader's state dicts must be bit-equal to
`from_jax` applied to `reface_tpu.ckpt.convert`'s params of the same file.
The tiny config's ArcFace has 512 channels in its last stage: the JAX
converter hard-codes output_fc's (512, 7, 7) input (convert.py:407).
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import random_tree
from test_torch_port_helpers import one_torch_thread

from reface_tpu.ckpt import convert as JC
from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.ckpt import from_torch as FT
from reface_tpu_torch.cli.common import add_model_args, build_swapper
from reface_tpu_torch.nn.bisenet import BiSeNet, BiSeNetConfig
from reface_tpu_torch.nn.clip import CLIPVisionConfig
from reface_tpu_torch.nn.safety import SafetyChecker, SafetyCheckerConfig
from reface_tpu_torch.pipelines.swap import SwapModules, init_params
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

WIDE_ARCFACE = "swap.conditioner.arcface.depths=[8,16,16,512]"


def _wide(cfg):
    cond = cfg.conditioner
    af = dataclasses.replace(cond.arcface, depths=(8, 16, 16, 512))
    return dataclasses.replace(cfg, conditioner=dataclasses.replace(cond, arcface=af))


JCFG, PCFG = _wide(j_tiny(64, 4)), _wide(p_tiny(64, 4))


def _towers(seed=0):
    mods = SwapModules(PCFG, device="cpu").towers()
    for i, m in enumerate(mods.values()):
        init_params(m, seed=seed + i, dezero=True)
    return {name: {k: v.clone() for k, v in m.state_dict().items()} for name, m in mods.items()}


def _lightning(sds, unet_prefix="model.diffusion_model."):
    """A Lightning checkpoint dict in REFace's layout."""
    sd = {**{unet_prefix + k: v for k, v in sds["unet"].items()},
          **{f"first_stage_model.{k}": v for k, v in sds["vae"].items()},
          **sds["conditioner"]}
    # LitEma keeps a shadow per UNet parameter, its name without the dots
    sd.update({"model_ema." + k.replace(".", ""): v + 1
               for k, v in sds["unet"].items() if v.is_floating_point()})
    sd["model_ema.num_updates"] = torch.tensor(7)
    return {"state_dict": sd, "global_step": 1234, "epoch": 3,
            "optimizer_states": [{"state": {0: {"exp_avg": torch.ones(3)}}}],
            "hyper_parameters": {"learning_rate": 1e-5, "unet_config": {"ch": 32}}}


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _jax_swap(sd, clip_sd=None, af_sd=None):
    params = JC.convert_reface_checkpoint(JCFG, _np(sd), clip_sd and _np(clip_sd),
                                          af_sd and _np(af_sd))
    return {"unet": from_jax.unet_from_jax(params["unet"]),
            "vae": from_jax.vae_from_jax(params["vae"]),
            "conditioner": from_jax.conditioner_from_jax(params["conditioner"])}


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 or not got[k].is_floating_point(), k
        assert torch.equal(got[k], v.to(got[k].dtype)), k


@pytest.fixture(scope="module")
def last_ckpt(tmp_path_factory):
    sds = _towers()
    path = tmp_path_factory.mktemp("ckpt") / "last.ckpt"
    torch.save(_lightning(sds), path)
    return path, sds


def test_last_ckpt_matches_the_reference_converter(last_ckpt):
    """last.ckpt -> the port's three state dicts, bit-equal to
    convert_reface_checkpoint + from_jax; model_ema.* and the Lightning
    entries are ignored, and the tensors are the towers' own."""
    path, sds = last_ckpt
    sd = FT.load_torch_state_dict(path)
    assert "model_ema.num_updates" in sd and "global_step" not in sd
    got = FT.reface_state_dicts(PCFG, sd)
    want = _jax_swap(sd)
    for name in ("unet", "vae", "conditioner"):
        _assert_equal(got[name], want[name])
        _assert_equal(got[name], sds[name])


def test_standalone_clip_and_arcface_files(last_ckpt, tmp_path):
    """A checkpoint without the CLIP tower takes it from an HF CLIP file
    (merged under cond_stage_model. with model. prefixed); an ArcFace file
    replaces the checkpoint's face_ID_model.facenet.* as a whole."""
    path, sds = last_ckpt
    sd = FT.load_torch_state_dict(path)
    tower = "cond_stage_model.model."
    clip_sd = {k[len(tower):]: v for k, v in sd.items() if k.startswith(tower)}
    clip_sd["text_model.embeddings.token_embedding.weight"] = torch.zeros(4, 8)
    af = "face_ID_model.facenet."
    af_sd = {k[len(af):]: v for k, v in sd.items() if k.startswith(af)}
    # the checkpoint's own ArcFace differs (and lacks a key): the file wins
    sd = {k: (v + 1 if k.startswith(af) and v.is_floating_point() else v)
          for k, v in sd.items() if not k.startswith(tower)}
    del sd[af + "input_layer.0.weight"]
    torch.save(clip_sd, tmp_path / "clip.pth")
    torch.save(af_sd, tmp_path / "arcface.pth")
    clip_sd = FT.load_torch_state_dict(tmp_path / "clip.pth")
    af_sd = FT.load_torch_state_dict(tmp_path / "arcface.pth")
    got = FT.reface_state_dicts(PCFG, sd, clip_sd, af_sd)
    _assert_equal(got["conditioner"], _jax_swap(sd, clip_sd, af_sd)["conditioner"])
    _assert_equal(got["conditioner"], sds["conditioner"])
    with pytest.raises(FT.CheckpointError, match="cond_stage_model.model.vision_model"):
        FT.reface_state_dicts(PCFG, sd, None, af_sd)
    # the file replaces the checkpoint's ArcFace: a key only the checkpoint
    # holds does not fill a gap in the file, in either package
    short = {k: v for k, v in af_sd.items() if k != "output_layer.3.bias"}
    with pytest.raises(FT.CheckpointError, match="face_ID_model.facenet.output_layer.3.bias"):
        FT.reface_state_dicts(PCFG, sd, clip_sd, short)
    with pytest.raises(JC.ConversionError, match="output_layer.3.bias"):
        JC.convert_reface_checkpoint(JCFG, _np(sd), _np(clip_sd), _np(short))


def test_missing_key_and_wrong_shape_raise(last_ckpt):
    """A missing key names itself; a wrong shape names the key and both
    shapes; a 4-channel SD conv_in is refused until expand_conv_in pads it
    with zeros, as the JAX package's expand_conv_in does."""
    path, _ = last_ckpt
    sd = FT.load_torch_state_dict(path)
    key = "model.diffusion_model.out.2.bias"
    with pytest.raises(FT.CheckpointError, match=r"unet: 1 keys missing(?s:.*)out\.2\.bias"):
        FT.reface_state_dicts(PCFG, {k: v for k, v in sd.items() if k != key})
    conv_in = "model.diffusion_model.input_blocks.0.0.weight"
    sd4 = dict(sd)
    sd4[conv_in] = sd[conv_in][:, :4].clone()
    with pytest.raises(FT.CheckpointError, match=r"shape mismatch input_blocks\.0\.0\.weight"):
        FT.reface_state_dicts(PCFG, sd4)
    with pytest.raises(JC.ConversionError, match="shape mismatch"):
        JC.convert_reface_checkpoint(JCFG, _np(sd4))
    padded = FT.expand_conv_in(sd4)
    np.testing.assert_array_equal(padded[conv_in].numpy(),
                                  JC.expand_conv_in(_np(sd4))[conv_in])
    unet = FT.reface_state_dicts(PCFG, padded)["unet"]["input_blocks.0.0.weight"]
    assert torch.equal(unet[:, :4], sd[conv_in][:, :4]) and not unet[:, 4:].any()


def _diffusers_safety(cfg, seed=0):
    """A diffusers-layout StableDiffusionSafetyChecker state dict from a
    seeded port checker."""
    m = SafetyChecker(cfg, device="cpu")
    init_params(m, seed=seed, dezero=True)
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in m.state_dict().items():
        if k.startswith("tower.vision_model."):
            sd["vision_model.vision_model." + k[len("tower.vision_model."):]] = v
        elif k == "tower.visual_projection.weight":
            sd["visual_projection.weight"] = v
        else:
            sd[k] = torch.randn(v.shape, generator=g)
    sd["vision_model.vision_model.embeddings.position_ids"] = torch.arange(5)[None]
    return sd


def test_bisenet_and_safety_files_match_the_reference_converters():
    """79999_iter.pth's layout against convert_bisenet, and diffusers' safety
    checker against convert_safety_checker, each through from_jax."""
    from reface_tpu.nn.bisenet import BiSeNet as JBiSeNet
    from reface_tpu.nn.bisenet import BiSeNetConfig as JBiSeNetConfig
    from reface_tpu.nn.clip import CLIPVisionConfig as JCLIPConfig
    from reface_tpu.nn.clip import CLIPVisionTower as JTower

    bn = BiSeNet(BiSeNetConfig(dtype=torch.float32), device="cpu")
    init_params(bn, seed=3, dezero=True)
    sd = {k: v.clone() for k, v in bn.state_dict().items()}
    shapes = jax.eval_shape(lambda k: JBiSeNet(JBiSeNetConfig()).init(
        k, jnp.zeros((1, 64, 64, 3)), aux_heads=True), jax.random.key(0))
    want = from_jax.bisenet_from_jax(JC.convert_bisenet(shapes, _np(sd)))
    got = FT.bisenet_state_dict(sd)
    _assert_equal(got, {k: want[k] for k in got})
    _assert_equal(got, sd)

    kw = dict(hidden=64, layers=1, heads=4, patch=56, image_size=224)
    cfg = SafetyCheckerConfig(clip=CLIPVisionConfig(**kw, dtype=torch.float32))
    sd = _diffusers_safety(cfg)
    shapes = jax.eval_shape(JTower(JCLIPConfig(**kw, dtype=jnp.float32)).init,
                            jax.random.key(0), jnp.zeros((1, 224, 224, 3)))
    jp = JC.convert_safety_checker(shapes, _np(sd))
    tower = from_jax.clip_conditioner_from_jax({"tower": jp["tower"]["params"]})
    want = {"tower." + k[len("model."):]: v for k, v in tower.items()}
    for ours, theirs in (("concept_embeds", "concept_embeds"),
                         ("concept_embeds_weights", "concept_thresholds"),
                         ("special_care_embeds", "special_embeds"),
                         ("special_care_embeds_weights", "special_thresholds")):
        want[ours] = torch.from_numpy(jp[theirs])
    _assert_equal(FT.safety_state_dict(sd, cfg), want)


def _args(*argv):
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    return ap.parse_args(["--device", "cpu", "--tiny", "--overrides", WIDE_ARCFACE, *argv])


def test_save_params_then_ckpt_round_trip(last_ckpt, tmp_path):
    """--ckpt last.ckpt --save-params FILE, then --ckpt FILE: the same
    tensors in every tower (here at --weights-dtype float32 and at the
    default bfloat16 rounding), and an orbax directory is refused with the
    converter's name."""
    path, sds = last_ckpt
    out = tmp_path / "swap.pt"
    for wd in ("float32", "bfloat16"):
        a = build_swapper(_args("--ckpt", str(path), "--save-params", str(out),
                                "--weights-dtype", wd))
        b = build_swapper(_args("--ckpt", str(out), "--weights-dtype", wd))
        for name, m in a.towers().items():
            sb = b.towers()[name].state_dict()
            for k, v in m.state_dict().items():
                assert torch.equal(v, sb[k]), (name, k)
                ref = sds[name][k]
                if ref.is_floating_point() and wd == "bfloat16" and ref.dtype == torch.float32:
                    ref = ref.to(torch.bfloat16)
                assert torch.equal(v, ref.to(v.dtype)), (name, k)
    with pytest.raises(SystemExit, match="jax_params_to_torch.py"):
        build_swapper(_args("--ckpt", str(tmp_path)))


def test_jax_params_to_torch(tmp_path):
    """scripts/jax_params_to_torch.py: an orbax tree of the JAX swap towers
    and one of a LandmarkNet become files that --ckpt and --landmark-ckpt
    read, equal to swap_from_jax / landmark_net_from_jax of the trees."""
    from reface_tpu.ckpt.io import save_params
    from reface_tpu.nn.landmarks import LandmarkNet as JLandmarkNet
    from reface_tpu.nn.landmarks import LandmarkNetConfig as JLandmarkNetConfig
    from reface_tpu.pipelines.swap import FaceSwapper as JSwapper
    from scripts.jax_params_to_torch import main

    shapes = jax.eval_shape(lambda k: JSwapper.init_params(JCFG, k), jax.random.key(0))
    params = {n: random_tree(t, seed=i) for i, (n, t) in enumerate(shapes.items())}
    lcfg = JLandmarkNetConfig(widths=(8, 16, 32, 32), input_size=64, dtype=jnp.float32)
    lm = random_tree(jax.eval_shape(JLandmarkNet(lcfg).init, jax.random.key(0),
                                    jnp.zeros((1, 64, 64, 3))), seed=5)
    save_params(str(tmp_path / "swap_dir"), params)
    save_params(str(tmp_path / "lm_dir"), lm)
    main(["--swap", str(tmp_path / "swap_dir"), "--swap-out", str(tmp_path / "swap.pt"),
          "--landmark", str(tmp_path / "lm_dir"), "--landmark-out", str(tmp_path / "lm.pt")])
    sw = build_swapper(_args("--ckpt", str(tmp_path / "swap.pt"), "--weights-dtype", "float32"))
    want = from_jax.swap_from_jax(params)
    for name, m in sw.towers().items():
        _assert_equal({k: v for k, v in m.state_dict().items()}, want[name])
    got = FT.load_torch_state_dict(tmp_path / "lm.pt")
    _assert_equal(got, from_jax.landmark_net_from_jax(lm))
