"""The port's state-dict names are the reference checkpoint's: port state
dicts laid out as a REFace last.ckpt convert to flax with the JAX
package's converter and come back unchanged; and init_params(dezero=True)
reaches every layer.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_port_helpers import state_dict_np
from test_torch_port_helpers import one_torch_thread

from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.nn.conditioner import REFaceConditioner as PCond
from reface_tpu_torch.nn.unet import UNetModel as PUNet
from reface_tpu_torch.nn.vae import AutoencoderKL as PVAE
from reface_tpu_torch.pipelines.swap import init_params
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

JCFG, PCFG = j_tiny(64, 2), p_tiny(64, 2)


# ---------------------------------------------------------------- layers


# ---------------------------------------------------------------- UNet


# ---------------------------------------------------------------- VAE


# ------------------------------------------------------- conditioning towers


# ------------------------------------------------------- names = checkpoint's

def _wide_arcface(cfg):
    """cfg with an ArcFace whose last stage has 512 channels: the reference
    converter hard-codes output_fc's (512, 7, 7) input (convert.py:407)."""
    cond = cfg.conditioner
    af = dataclasses.replace(cond.arcface, depths=(8, 16, 16, 512))
    return dataclasses.replace(cfg, conditioner=dataclasses.replace(cond, arcface=af))


def test_state_dict_round_trip_through_reference_converter():
    """Port state_dicts, laid out as a REFace last.ckpt, convert to flax with
    reface_tpu.ckpt.convert (convert_reface_checkpoint, which runs
    convert_unet, convert_vae, convert_clip_conditioner and convert_arcface)
    and come back through from_jax unchanged: every port key is a reference
    checkpoint key, and none is missing."""
    from reface_tpu.ckpt.convert import convert_reface_checkpoint

    jcfg, pcfg = _wide_arcface(JCFG), _wide_arcface(PCFG)
    towers = {"unet": PUNet(pcfg.unet), "vae": PVAE(pcfg.vae),
              "conditioner": PCond(pcfg.conditioner)}
    for i, m in enumerate(towers.values()):
        init_params(m, seed=i, dezero=True)
    sds = {name: state_dict_np(m) for name, m in towers.items()}
    ckpt = {**{f"model.diffusion_model.{k}": v for k, v in sds["unet"].items()},
            **{f"first_stage_model.{k}": v for k, v in sds["vae"].items()},
            **sds["conditioner"]}
    params = convert_reface_checkpoint(jcfg, ckpt)
    back = {"unet": from_jax.unet_from_jax(params["unet"]),
            "vae": from_jax.vae_from_jax(params["vae"]),
            "conditioner": from_jax.conditioner_from_jax(params["conditioner"])}
    for name in towers:
        assert set(back[name]) == set(sds[name]), name
        for k, v in sds[name].items():
            np.testing.assert_array_equal(back[name][k].numpy(), v, err_msg=k)


def test_init_params_dezero_reaches_every_layer():
    """init_params(dezero=True) leaves no all-zero parameter (so an output
    depends on every layer) and is deterministic in its seed."""
    a = init_params(PUNet(PCFG.unet), seed=3, dezero=True)
    b = init_params(PUNet(PCFG.unet), seed=3, dezero=True)
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.any(), k
        assert torch.equal(p, q), k
    plain = init_params(PUNet(PCFG.unet), seed=3)
    assert not plain.out[2].weight.any()  # the reference's zero init
