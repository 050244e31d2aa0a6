"""The evaluation modules of the port (reface_tpu_torch/eval, the eval
readers of ckpt/from_torch.py) against the JAX package's (reface_tpu/eval,
reface_tpu/ckpt/convert.py), on the same numpy-seeded inputs with the JAX
params carried across by ckpt/from_jax.py:

- the ResNet-50 towers (ResNet50, Hopenet, FaceReconCoeffNet with its
  seven heads), clip_features through an fp32 CLIP_B32, the ArcFace
  embeddings (embed_identities, id_embed_protocol), pose_angles,
  expression_coeffs and decode_hopenet_angles: ATOL 2e-4 in fp32;
- frechet_distance, clip_fid, id_retrieval_metrics, pose_l2 and
  expression_l2 on well-conditioned inputs: 1e-6 relative;
- the reference-layout files: each reader's state dict loads strict, equals
  the JAX convert_* of the same dict carried across, and Hopenet's
  fc_finetune is dropped by name while any other stray key raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reface_tpu.ckpt import convert as C
from reface_tpu.eval import backbones as JB
from reface_tpu.eval import expression as JX
from reface_tpu.eval import fid as JF
from reface_tpu.eval import id_retrieval as JI
from reface_tpu.eval import pose as JP
from reface_tpu.eval import protocol as JPR
from reface_tpu.nn.arcface import ArcFaceConfig as JArcFaceConfig
from reface_tpu.nn.arcface import IRSE50 as JIRSE50
from reface_tpu.nn.clip import CLIPVisionTower as JCLIPVisionTower
from reface_tpu_torch.ckpt import from_jax as FJ
from reface_tpu_torch.ckpt import from_torch as R
from reface_tpu_torch.eval import backbones as PB
from reface_tpu_torch.eval import expression as PX
from reface_tpu_torch.eval import fid as PF
from reface_tpu_torch.eval import id_retrieval as PI
from reface_tpu_torch.eval import pose as PP
from reface_tpu_torch.eval import protocol as PPR
from reface_tpu_torch.nn.arcface import ArcFaceConfig, IRSE50
from reface_tpu_torch.nn.clip import CLIPVisionTower
from reface_tpu_torch.pipelines.swap import init_params
from test_torch_port_helpers import assert_close, init_jax, load, nchw
from test_torch_port_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

REL = 1e-6
# a narrow IR-SE-50 (the JAX converter fixes the output fc at 512 channels)
TINY_ARCFACE = dict(depths=(8, 16, 16, 512), units=(1, 1, 1, 1))
# a narrow CLIP tower for the file readers (clip_features runs CLIP_B32)
TINY_CLIP = dict(hidden=64, layers=2, heads=4, patch=32, image_size=224, projection_dim=32)


def _images(n, size, seed):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(np.float32)


def _zeros_like_shapes(module, *args):
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _assert_state_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k].float()), k


TOWERS = {
    "resnet50": (JB.ResNet50, PB.ResNet50, FJ.resnet50_from_jax),
    "hopenet": (JB.Hopenet, PB.Hopenet, FJ.hopenet_from_jax),
    "facerecon": (JB.FaceReconCoeffNet, PB.FaceReconCoeffNet, FJ.facerecon_from_jax),
}


@pytest.mark.parametrize("name", list(TOWERS))
def test_backbone_matches_jax(name):
    jcls, pcls, carry = TOWERS[name]
    x = _images(2, 64, seed=1)
    params = init_jax(jcls(), jnp.zeros((1, 64, 64, 3)), seed=2)
    want = jcls().apply(params, x)
    net = load(pcls(), carry(params))
    with torch.no_grad():
        got = net(nchw(x))
    if name == "hopenet":
        for g, w in zip(got, want):
            assert_close(g, w)
            assert_close(PB.decode_hopenet_angles(g), JB.decode_hopenet_angles(w))
    else:
        assert got.shape == want.shape
        assert_close(got, want)
    if name == "facerecon":
        for part, t in PB.FaceReconCoeffNet.split_coeffs(got).items():
            assert_close(t, JB.FaceReconCoeffNet.split_coeffs(want)[part])


def test_clip_features_matches_jax():
    jcfg = dataclasses.replace(JF.CLIP_B32, dtype=jnp.float32)
    params = init_jax(JCLIPVisionTower(jcfg), jnp.zeros((1, 224, 224, 3)), seed=3)
    x = _images(3, 224, seed=4)
    want = JF.clip_features(params, jnp.asarray(x), config=jcfg, batch_size=2)
    tower = load(CLIPVisionTower(dataclasses.replace(PF.CLIP_B32, dtype=torch.float32)),
                 FJ.clip_vision_from_jax(params))
    got = PF.clip_features(tower, x, batch_size=2)
    assert got.shape == (3, 512) and got.dtype == np.float32
    assert_close(got, want)


def test_identity_embeddings_match_jax():
    jcfg = JArcFaceConfig(dtype=jnp.float32, **TINY_ARCFACE)
    params = init_jax(JIRSE50(jcfg), jnp.zeros((1, 112, 112, 3)), seed=5)
    net = load(IRSE50(ArcFaceConfig(dtype=torch.float32, **TINY_ARCFACE)),
               FJ.arcface_from_jax(params))
    x = _images(3, 112, seed=6) * 2 - 1
    assert_close(PI.embed_identities(net, x, batch_size=2),
                 JI.embed_identities(params, jnp.asarray(x), batch_size=2, config=jcfg))
    assert_close(PPR.id_embed_protocol(net, x, batch_size=2),
                 JPR.id_embed_protocol(params, x, batch_size=2, config=jcfg))


def test_pose_and_expression_match_jax():
    x = _images(3, 64, seed=7)
    hp = init_jax(JB.Hopenet(), jnp.zeros((1, 64, 64, 3)), seed=8)
    want = JP.pose_angles(hp, jnp.asarray(x), batch_size=2)
    got = PP.pose_angles(load(PB.Hopenet(), FJ.hopenet_from_jax(hp)), x, batch_size=2)
    assert got.shape == (3, 3)
    assert_close(got, want)
    fr = init_jax(JB.FaceReconCoeffNet(), jnp.zeros((1, 64, 64, 3)), seed=9)
    want = JX.expression_coeffs(fr, jnp.asarray(x), batch_size=2)
    got = PX.expression_coeffs(load(PB.FaceReconCoeffNet(), FJ.facerecon_from_jax(fr)), x,
                               batch_size=2)
    assert got.shape == (3, 64)
    assert_close(got, want)


def test_metrics_match_jax():
    rng = np.random.default_rng(10)
    # 64 samples of 16 features: full-rank covariances, a well-posed sqrtm
    a = rng.normal(0.0, 1.0, (64, 16))
    b = rng.normal(0.3, 1.2, (80, 16))
    np.testing.assert_allclose(PF.clip_fid(a, b), JF.clip_fid(a, b), rtol=REL)
    mu, s = a.mean(0), np.cov(a, rowvar=False)
    mu2, s2 = b.mean(0), np.cov(b, rowvar=False)
    np.testing.assert_allclose(PF.frechet_distance(mu, s, mu2, s2),
                               JF.frechet_distance(mu, s, mu2, s2), rtol=REL)
    assert abs(PF.frechet_distance(mu, s, mu, s)) < 1e-8

    src = rng.normal(size=(12, 32))
    src /= np.linalg.norm(src, axis=1, keepdims=True)
    swap = src[[3, 1, 4, 1, 5, 9, 2, 6]] + rng.normal(0.0, 0.6, (8, 32))
    swap /= np.linalg.norm(swap, axis=1, keepdims=True)
    true_idx = np.array([3, 1, 4, 1, 5, 9, 2, 6])
    got = PI.id_retrieval_metrics(swap, src, true_idx)
    want = JI.id_retrieval_metrics(swap, src, true_idx)
    assert set(got) == {"top1", "top5", "mean_id_cosine"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=REL)

    t, s_ = rng.normal(0, 20, (9, 3)), rng.normal(0, 20, (9, 3))
    np.testing.assert_allclose(PP.pose_l2(t, s_), JP.pose_l2(t, s_), rtol=REL)
    t, s_ = rng.normal(size=(9, 64)), rng.normal(size=(9, 64))
    np.testing.assert_allclose(PX.expression_l2(t, s_), JX.expression_l2(t, s_), rtol=REL)

    logits = rng.normal(0.0, 3.0, (5, 66)).astype(np.float32)
    assert_close(PB.decode_hopenet_angles(torch.from_numpy(logits)),
                 JB.decode_hopenet_angles(logits))


def _seeded(module, seed):
    init_params(module, seed=seed, dezero=True)
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _clip_file():
    """An HF CLIPModel file: the vision tower, its projection, a text-tower
    entry, logit_scale and HF's position_ids buffer."""
    from reface_tpu_torch.nn.clip import CLIPVisionConfig

    cfg = CLIPVisionConfig(dtype=torch.float32, **TINY_CLIP)
    want = _seeded(CLIPVisionTower(cfg), 11)
    sd = {**want, "text_model.embeddings.token_embedding.weight": torch.zeros(8, 4),
          "text_projection.weight": torch.zeros(4, 4), "logit_scale": torch.tensor(2.6),
          "vision_model.embeddings.position_ids": torch.arange(50)[None]}
    jcfg = JF.CLIPVisionConfig(dtype=jnp.float32, **TINY_CLIP)
    shapes = _zeros_like_shapes(JCLIPVisionTower(jcfg), jnp.zeros((1, 224, 224, 3)))
    jax_params = C.convert_clip_vision(shapes, {k: v.numpy() for k, v in sd.items()})
    got = R.clip_vision_state_dict(sd, cfg)
    load(CLIPVisionTower(cfg), got)
    return got, want, FJ.clip_vision_from_jax(jax_params)


def _hopenet_file():
    want = _seeded(PB.Hopenet(), 12)
    sd = {**want, "fc_finetune.weight": torch.ones(66, 2048), "fc_finetune.bias": torch.ones(66)}
    got, dropped = R.hopenet_state_dict(sd)
    assert dropped == ["fc_finetune.bias", "fc_finetune.weight"]
    with pytest.raises(R.CheckpointError, match="fc_extra.weight"):
        R.hopenet_state_dict({**sd, "fc_extra.weight": torch.ones(1)})
    load(PB.Hopenet(), got)
    # a file from before torch 0.4.1 has no num_batches_tracked: it loads
    # (the count 0), and the JAX converter gives the same tensors; another
    # missing BatchNorm entry still raises
    old = {k: v for k, v in sd.items() if not k.endswith(".num_batches_tracked")}
    assert len(sd) - len(old) == 53
    _assert_state_equal(R.hopenet_state_dict(old)[0], got)
    with pytest.raises(R.CheckpointError, match="bn1.running_var"):
        R.hopenet_state_dict({k: v for k, v in old.items() if k != "bn1.running_var"})
    shapes = _zeros_like_shapes(JB.Hopenet(), jnp.zeros((1, 64, 64, 3)))
    jax_params = C.convert_hopenet(shapes, {k: v.numpy() for k, v in old.items()})
    return got, want, FJ.hopenet_from_jax(jax_params)


def _facerecon_file():
    """Deep3DFaceRecon's layout: net_recon.backbone.* and the seven
    net_recon.final_layers.*, flat, nested under "net_recon", and the flat
    conv1.* / final_layers.* the JAX evaluate driver reads."""
    want = _seeded(PB.FaceReconCoeffNet(), 13)
    ref = {("net_recon." if k.startswith("final_layers.") else "net_recon.backbone.") + k: v
           for k, v in want.items()}
    got = R.facerecon_state_dict(ref)
    load(PB.FaceReconCoeffNet(), got)
    nested = {"net_recon": {k[len("net_recon."):]: v for k, v in ref.items()}, "epoch": 20}
    _assert_state_equal(R.facerecon_state_dict(nested), got)
    _assert_state_equal(R.facerecon_state_dict(want), got)
    old = {k: v for k, v in ref.items() if not k.endswith(".num_batches_tracked")}
    assert len(ref) - len(old) == 53
    _assert_state_equal(R.facerecon_state_dict(old), got)
    shapes = _zeros_like_shapes(JB.FaceReconCoeffNet(), jnp.zeros((1, 64, 64, 3)))
    jax_params = C.convert_facerecon(shapes, {k: v.numpy() for k, v in old.items()},
                                     prefix="net_recon.backbone.")
    return got, want, FJ.facerecon_from_jax(jax_params)


def _arcface_file():
    cfg = ArcFaceConfig(dtype=torch.float32, **TINY_ARCFACE)
    want = _seeded(IRSE50(cfg), 14)
    got = R.arcface_state_dict(want, cfg)
    load(IRSE50(cfg), got)
    shapes = _zeros_like_shapes(JIRSE50(JArcFaceConfig(dtype=jnp.float32, **TINY_ARCFACE)),
                                jnp.zeros((1, 112, 112, 3)))
    jax_params = C.convert_arcface(shapes, {k: v.numpy() for k, v in want.items()})
    return got, want, FJ.arcface_from_jax(jax_params)


FILES = {"clip": _clip_file, "hopenet": _hopenet_file, "facerecon": _facerecon_file,
         "arcface": _arcface_file}


@pytest.mark.parametrize("name", list(FILES))
def test_reference_file_reader(name):
    got, want, via_jax = FILES[name]()
    _assert_state_equal(got, want)
    # the JAX converter on the same dict, carried across, gives the same
    # tensors (num_batches_tracked, absent from the flax tree, is 0 both ways)
    _assert_state_equal(via_jax, got)
