"""The landmark auxiliary head of the port's full training loss against the
JAX package, on the CPU: LandmarkAuxHead, the UNet's return_features that
feeds it, and the training loss with landmark_weight > 0. A file of its own
beside test_torch_port_losses.py, so that the two jits of the JAX loss's
value_and_grad can run in two workers.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import (
    assert_close,
    check_full_loss_matches_jax,
    full_loss_setup,
    init_jax,
    load,
    nchw,
    nhwc,
    one_torch_thread,
)

from reface_tpu.nn.landmarks import LandmarkAuxHead as JHead
from reface_tpu.nn.unet import UNetModel as JUNet
from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.nn.landmarks import LandmarkAuxHead
from reface_tpu_torch.nn.unet import UNetModel, decoder_feature_shapes
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def test_landmark_aux_head_matches_jax():
    """LandmarkAuxHead with converted weights within 1e-5: the flax head
    flattens NHWC before fc, the port NCHW, so fc's rows are permuted."""
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
    params = init_jax(JHead(), jnp.asarray(feats), seed=3)
    ref = JHead().apply(params, jnp.asarray(feats))
    head = load(LandmarkAuxHead(64, 8, device="cpu"), from_jax.landmark_head_from_jax(params))
    assert_close(head(nchw(feats)), ref, atol=1e-5)


@pytest.fixture(scope="module")
def unet_features_ref():
    """The JAX UNet of tiny_swap_config(64), its inputs, and its eps and
    decoder features (return_features=True): the reference of both remat
    cases, built once."""
    jcfg = j_tiny(64).unet
    rng = np.random.default_rng(4)
    x9 = rng.normal(size=(2, 8, 8, 9)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    ctx = rng.normal(size=(2, 1, 768)).astype(np.float32)
    params = init_jax(JUNet(jcfg), jnp.asarray(x9), jnp.asarray(t), jnp.asarray(ctx), seed=5)
    ref, ref_feats = JUNet(jcfg).apply(params, jnp.asarray(x9), jnp.asarray(t),
                                       jnp.asarray(ctx), return_features=True)
    return params, (x9, t, ctx), ref, ref_feats


@pytest.mark.parametrize("remat", [False, True])
def test_unet_return_features_matches_jax(unet_features_ref, remat):
    """return_features: eps and every decoder block's activation within 2e-4
    (the towers' tolerance), also under remat with gradients recorded; the
    shapes are those decoder_feature_shapes reads from the config."""
    pcfg = p_tiny(64).unet
    params, (x9, t, ctx), ref, ref_feats = unet_features_ref
    net = UNetModel(dataclasses.replace(pcfg, remat=remat), device="cpu")
    net.load_state_dict(from_jax.unet_from_jax(params))
    with torch.set_grad_enabled(remat):
        out, feats = net(nchw(x9), torch.from_numpy(t), torch.from_numpy(ctx),
                         return_features=True)
    assert_close(nhwc(out), ref)
    assert len(feats) == len(ref_feats)
    assert [(f.shape[1], f.shape[2]) for f in feats] == decoder_feature_shapes(pcfg, 8)
    for f, r in zip(feats, ref_feats):
        assert_close(nhwc(f), r)


def test_loss_with_landmark_head_matches_jax():
    """The landmark aux head in the training loss (landmark_weight 0.5 and a
    "landmark_head" tree): loss_simple, loss_landmark and every trainable
    gradient, the head's too, against the JAX package (the limits are in
    test_torch_port_helpers.check_full_loss_matches_jax). The ID and LPIPS
    weights are 0 here, which ends the loss after the eps-MSE forward that
    the head shares: the reconstruction terms are additive and held to the
    JAX package in test_torch_port_losses.py, and the jit of this half
    takes 20 s where the whole loss takes 50."""
    named = check_full_loss_matches_jax(
        full_loss_setup(), want_metrics={"loss_simple", "loss_landmark"},
        frozen={"vae", "conditioner"},
        landmark_weight=0.5, id_weight=0.0, lpips_weight=0.0)
    assert named["landmark_head.fc.weight"].requires_grad
    assert named["landmark_head.fc.weight"].grad.abs().max() > 0
    assert named["landmark_head.conv.weight"].grad.abs().max() > 0
