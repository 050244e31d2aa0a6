"""The raw path's parsers in reface_tpu_torch against the JAX package, fp32,
CPU, at 64 px: BiSeNet (logits and the two auxiliary heads), parse_faces,
bisenet_from_jax and the face-parsing checkpoint's names, LandmarkNet (the
tiny raw config's widths) with landmark_net_from_jax, soft_argmax_2d and
landmark_fn_from_net.

Weights are random numpy leaves (test_torch_port_helpers.random_tree)
carried JAX -> port through reface_tpu_torch.ckpt.from_jax; inputs come from
a numpy seed. Logits and landmarks are held to ATOL (2e-4), the class maps
to equality wherever the JAX logits' top two are further apart than that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import ATOL, init_jax, load, nchw, nhwc, one_torch_thread, random_tree

from reface_tpu.ckpt.convert import _bisenet_rule, _flatten_tree, convert_bisenet
from reface_tpu.nn.bisenet import BiSeNet as JBiSeNet
from reface_tpu.nn.bisenet import BiSeNetConfig as JBiSeNetConfig
from reface_tpu.nn.bisenet import parse_faces as j_parse
from reface_tpu.nn.landmarks import LandmarkNet as JLandmarkNet
from reface_tpu.nn.landmarks import LandmarkNetConfig as JLMConfig
from reface_tpu.nn.landmarks import landmark_fn_from_net as j_lm_fn
from reface_tpu.nn.landmarks import soft_argmax_2d as j_soft_argmax
from reface_tpu.preprocess.masks import FACE_PARSING_TO_SEG12
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.nn.bisenet import BiSeNet, BiSeNetConfig, parse_faces
from reface_tpu_torch.nn.landmarks import (
    LandmarkNet,
    LandmarkNetConfig,
    landmark_fn_from_net,
    soft_argmax_2d,
)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)
F32 = torch.float32
TINY_LM = dict(widths=(8, 16, 32, 32), input_size=64)


@pytest.fixture(scope="module")
def bisenet():
    """(JAX module, its params with the aux heads, the port module)."""
    jm = JBiSeNet(JBiSeNetConfig(dtype=jnp.float32))
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, aux_heads=True),
                            jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    params = random_tree(shapes, seed=1)
    pm = load(BiSeNet(BiSeNetConfig(dtype=F32)), from_jax.bisenet_from_jax(params))
    return jm, params, pm


def _images(b=2, size=64, seed=2):
    return np.random.default_rng(seed).uniform(size=(b, size, size, 3)).astype(np.float32)


def test_bisenet_matches_jax(bisenet):
    """The logits and both auxiliary heads, fp32 (upsampled to the input by
    the align-corners resize)."""
    jm, params, pm = bisenet
    x = (_images() - 0.45) / 0.25
    refs = jm.apply(params, jnp.asarray(x), aux_heads=True)
    with torch.no_grad():
        gots = pm(nchw(x), aux_heads=True)
    assert np.abs(np.asarray(refs[0])).max() > 0.1  # not a vanishing output
    for got, ref in zip(gots, refs):
        assert got.dtype == F32 and got.shape == (2, 19, 64, 64)
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=ATOL, rtol=0)
    with torch.no_grad():
        np.testing.assert_array_equal(pm(nchw(x)).numpy(), gots[0].numpy())


def test_parse_faces_matches_jax(bisenet):
    """The 19-class and the seg12 maps equal the JAX ones wherever the
    top-two JAX logits are more than ATOL apart; ties go to the first
    class, as jnp.argmax's."""
    jm, params, pm = bisenet
    x = _images(seed=3)
    logits = np.asarray(jm.apply(params, (jnp.asarray(x) - jnp.asarray([0.485, 0.456, 0.406]))
                                 / jnp.asarray([0.229, 0.224, 0.225])))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > ATOL
    assert clear.mean() > 0.99
    with torch.no_grad():
        for lut in (None, FACE_PARSING_TO_SEG12):
            ref = np.asarray(j_parse(jm, params, jnp.asarray(x), remap_lut=lut))
            got = parse_faces(pm, nchw(x), remap_lut=lut)
            assert got.dtype == torch.int32 and got.shape == (2, 64, 64)
            np.testing.assert_array_equal(got.numpy()[clear], ref[clear])
        assert len(np.unique(ref)) > 1

    class Tied:  # logits with exact ties between classes 2, 5 and 7
        def apply(self, _, x):
            z = jnp.zeros(x.shape[:3] + (19,)).at[..., jnp.array([2, 5, 7])].set(1.0)
            return z

        def __call__(self, x):
            z = torch.zeros((x.shape[0], 19) + x.shape[2:])
            z[:, [2, 5, 7]] = 1.0
            return z

    ref = np.asarray(j_parse(Tied(), None, jnp.asarray(x)))
    np.testing.assert_array_equal(parse_faces(Tied(), nchw(x)).numpy(), ref)
    assert (ref == 2).all()


def test_bisenet_checkpoint_names(bisenet):
    """The port's BiSeNet keys are the face-parsing checkpoint's as the JAX
    converter reads them (`_bisenet_rule`, plus BatchNorm's
    num_batches_tracked): a state dict keyed by the rule loads strictly, and
    convert_bisenet reads the port's state dict back into the JAX params
    exactly."""
    jm, params, pm = bisenet
    sd = pm.state_dict()
    rule_keys = {_bisenet_rule(path)[0] for path in _flatten_tree(params)}
    assert {k for k in sd if not k.endswith("num_batches_tracked")} == rule_keys
    assert "cp.resnet.layer1.0.conv1.weight" in rule_keys
    assert "ffm.convblk.bn.running_mean" in rule_keys
    ckpt = {k: v.clone() for k, v in sd.items()}
    fresh = BiSeNet(BiSeNetConfig(dtype=F32))
    fresh.load_state_dict(ckpt)  # strict
    back = convert_bisenet(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                        params),
                           {k: v.numpy() for k, v in sd.items()})
    flat_back, flat = _flatten_tree(back), _flatten_tree(params)
    assert flat_back.keys() == flat.keys()
    for path, a in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(a))


@pytest.fixture(scope="module")
def landmark_net():
    jm = JLandmarkNet(JLMConfig(dtype=jnp.float32, **TINY_LM))
    params = init_jax(jm, jnp.zeros((1, 64, 64, 3)), seed=4)
    pm = load(LandmarkNet(LandmarkNetConfig(dtype=F32, **TINY_LM)),
              from_jax.landmark_net_from_jax(params))
    return jm, params, pm


def test_landmark_net_matches_jax(landmark_net):
    """LandmarkNet at the tiny raw config's widths: (B, 136) pixel
    coordinates, the GroupNorms at 8 groups, the fp32 heatmap head."""
    jm, params, pm = landmark_net
    x = _images(3, seed=5) * 2 - 1
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(nchw(x))
    assert got.shape == (3, 136) and got.dtype == F32
    assert ref.std() > 0.1  # the landmarks move with the input
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    assert all(m.groups == 8 for n, m in pm.named_modules() if "norm" in n and n)
    assert pm.heat.weight.dtype == F32


def test_soft_argmax_and_landmark_fn_match_jax(landmark_net):
    """soft_argmax_2d on random heatmaps (NCHW against NHWC), and
    landmark_fn_from_net on [-1,1] images at another size (the resize to
    the net's input and the scale to image_size: ATOL at the net's 64 px,
    times 512 / 64)."""
    rng = np.random.default_rng(6)
    heat = (rng.normal(size=(2, 12, 9, 5)) * 3).astype(np.float32)
    ref = np.asarray(j_soft_argmax(jnp.asarray(heat)))
    np.testing.assert_allclose(soft_argmax_2d(nchw(heat)).numpy(), ref, atol=1e-5, rtol=0)
    jm, params, pm = landmark_net
    x = rng.uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    ref = np.asarray(j_lm_fn(jm, params, 512)(jnp.asarray(x)))
    got = landmark_fn_from_net(pm, 512)(x)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL * 8, rtol=0)
