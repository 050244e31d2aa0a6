"""The raw-image path end to end: reface_tpu_torch RawSwapPipeline against the
JAX package's on tiny_raw_config with tiny_swap_config(64, 2), fp32, CPU.

Both pipelines hold the same weights (random numpy leaves carried JAX ->
port through reface_tpu_torch.ckpt.from_jax: the towers, LandmarkNet,
BiSeNet with its auxiliary heads), run with sample_posterior=False, and
both swappers' `swap` are wrapped to inject the same x_T (eta = 0), so no
random draw is left. The JAX stages are jitted once each (the eager flax
path costs ~90 s on the CPU). The landmark -> quad -> crop chain amplifies
drift and BiSeNet's argmax and the nearest resize are discontinuous, so
each stage is held on the JAX side's own inputs at ATOL (2e-4) and each
whole path by a stated distance: 1e-3 max abs on [0,1] frames.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import ATOL, one_torch_thread, random_tree

from reface_tpu.data.synthetic import LANDMARK68_TEMPLATE
from reface_tpu.nn.bisenet import BiSeNet as JBiSeNet
from reface_tpu.nn.landmarks import LandmarkNet as JLandmarkNet
from reface_tpu.pipelines.raw import RawSwapPipeline as JRaw
from reface_tpu.pipelines.raw import tiny_raw_config as j_tiny_raw
from reface_tpu.pipelines.swap import FaceSwapper as JSwapper
from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.pipelines.raw import RawSwapPipeline, tiny_raw_config
from reface_tpu_torch.pipelines.swap import FaceSwapper, tiny_swap_config

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

PATH_TOL = 1e-3  # a whole path, on [0,1] frames


def _with_x_T(swapper, x_T, to):
    """Wrap swapper.swap to take the first rows of a fixed x_T."""
    swap = swapper.swap
    swapper.swap = lambda **kw: swap(**kw, x_T=to(x_T[:kw["target_image"].shape[0]]))


def template_landmarks(images):
    """A host landmark_fn: the iBUG-68 template over the middle of each
    (B, H, W, 3) image, as the ERT gives a face that fills its box."""
    b, h, w = images.shape[:3]
    pts = (LANDMARK68_TEMPLATE - 0.5) * np.float32(0.6) + np.float32(0.5)
    return np.broadcast_to(pts * np.array([w, h], np.float32), (b, 68, 2)).copy()


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline with jitted stages, port pipeline, inputs): the same
    weights and the same injected x_T (4 rows)."""
    jcfg = dataclasses.replace(j_tiny(64, 2), sample_posterior=False)
    shapes = jax.eval_shape(lambda k: JSwapper.init_params(jcfg, k), jax.random.key(0))
    params = {n: random_tree(t, seed=i) for i, (n, t) in enumerate(shapes.items())}
    rcfg = j_tiny_raw()
    lm_params = random_tree(jax.eval_shape(
        lambda k: JLandmarkNet(rcfg.landmark).init(k, jnp.zeros((1, 64, 64, 3))),
        jax.random.key(0)), seed=10)
    bn_params = random_tree(jax.eval_shape(
        lambda k: JBiSeNet(rcfg.bisenet).init(k, jnp.zeros((1, 64, 64, 3)), aux_heads=True),
        jax.random.key(0)), seed=11)
    jpipe = JRaw(JSwapper(jcfg, params), rcfg, landmark_params=lm_params,
                 bisenet_params=bn_params)
    for name in ("align", "parse", "face_mask"):
        setattr(jpipe, name, jax.jit(getattr(jpipe, name)))
    detect, net_detect = jpipe.detect_landmarks, jax.jit(jpipe.detect_landmarks)
    # jitted, detect_landmarks would take LandmarkNet also with a host landmark_fn
    jpipe.detect_landmarks = lambda im: (
        detect(im) if jpipe.landmark_fn is not None and not isinstance(im, jax.core.Tracer)
        else net_detect(im))

    pcfg = dataclasses.replace(tiny_swap_config(64, 2), sample_posterior=False)
    psw = FaceSwapper(pcfg, device="cpu", params={
        "unet": from_jax.unet_from_jax(params["unet"]),
        "vae": from_jax.vae_from_jax(params["vae"]),
        "conditioner": from_jax.conditioner_from_jax(params["conditioner"])})
    ppipe = RawSwapPipeline(psw, tiny_raw_config(), device="cpu",
                            landmark_params=from_jax.landmark_net_from_jax(lm_params),
                            bisenet_params=from_jax.bisenet_from_jax(bn_params))

    rng = np.random.default_rng(1)
    x_T = rng.normal(size=(4, 8, 8, 4)).astype(np.float32)
    _with_x_T(jpipe.swapper, x_T, jnp.asarray)
    _with_x_T(ppipe.swapper, x_T, torch.from_numpy)
    inputs = dict(tgt=rng.uniform(size=(2, 96, 96, 3)).astype(np.float32),
                  src=rng.uniform(size=(2, 80, 80, 3)).astype(np.float32),
                  frame=rng.uniform(size=(96, 128, 3)).astype(np.float32))
    return jpipe, ppipe, inputs


def _close(got, ref, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


def test_stages_match_jax(pipes):
    """detect_landmarks, align, parse and face_mask, and the source
    reference, each on the JAX side's own inputs."""
    jpipe, ppipe, x = pipes
    tgt = jnp.asarray(x["tgt"])
    j_lm = jpipe.detect_landmarks(tgt)
    _close(ppipe.detect_landmarks(x["tgt"]), j_lm, ATOL)
    j_crop, j_quads = jpipe.align(tgt, j_lm)
    p_crop, p_quads = ppipe.align(x["tgt"], np.asarray(j_lm))
    _close(p_quads, j_quads, ATOL)
    _close(p_crop, j_crop, ATOL)
    j_seg = np.asarray(jpipe.parse(j_crop))
    p_seg = ppipe.parse(np.asarray(j_crop))
    assert p_seg.dtype == torch.int32 and p_seg.shape == (2, 64, 64)
    np.testing.assert_array_equal(p_seg.numpy(), j_seg)
    assert len(np.unique(j_seg)) > 1
    _close(ppipe.face_mask(j_seg), jpipe.face_mask(jnp.asarray(j_seg)), 0)
    ref = jpipe._source_reference(jnp.asarray(x["src"]))
    _close(ppipe._source_reference(x["src"]), ref, ATOL * 10)  # CLIP-normalized, /0.27


def test_swap_images_matches_jax(pipes):
    """swap_images with the host landmark_fn within PATH_TOL; with
    LandmarkNet's landmarks 99% of the values within PATH_TOL (random
    weights put the 68 points within a few pixels, so the quad's homography
    scales the ~1e-5 px landmark drift tenfold and more, and the paste's hard
    alpha edge can flip whole pixels); swap_images_fused takes every landmark
    from LandmarkNet even with a host landmark_fn, so it equals
    swap_images without one."""
    jpipe, ppipe, x = pipes
    tgt, src = jnp.asarray(x["tgt"]), jnp.asarray(x["src"])
    net = ppipe.swap_images(x["tgt"], x["src"])
    close = np.abs(net.numpy() - np.asarray(jpipe.swap_images(tgt, src))) <= PATH_TOL
    assert close.mean() >= 0.99, close.mean()
    jpipe.landmark_fn = ppipe.landmark_fn = template_landmarks
    try:
        ref = np.asarray(jpipe.swap_images(tgt, src))
        got = ppipe.swap_images(x["tgt"], x["src"])
        fused = ppipe.swap_images_fused(x["tgt"], x["src"])
    finally:
        jpipe.landmark_fn = ppipe.landmark_fn = None
    assert got.shape == (2, 96, 96, 3) and torch.isfinite(got).all()
    assert np.abs(ref - x["tgt"]).max() > 0.1  # the swap changed the frames
    _close(got, ref, PATH_TOL)
    assert torch.equal(fused, net)


def _bright(t):
    """A presence signal that the JAX one-program path traces as data, not
    as a constant of its first trace: a frame "has a face" when its mean is
    above 0.5."""
    return (t.mean(axis=(1, 2, 3)) if isinstance(t, jax.Array)
            else torch.as_tensor(t).mean(dim=(1, 2, 3))) > 0.5


@pytest.mark.parametrize("one_program", [True, False])
def test_robust_matches_jax(pipes, one_program):
    """swap_images_robust with a host landmark_fn and a forced presence
    pattern: batch A [face, none] (frame 1 takes frame 0's swap), batch B
    [none, face] carrying A's state (frame 0 takes A's last good frame),
    batch C [none, none] without state (both pass through, state stays
    None). one_program=True takes the conditioning re-detect from
    LandmarkNet, False from the host function; the fallback decisions and
    states equal the JAX package's, the frames within the path tolerance."""
    jpipe, ppipe, x = pipes
    jpipe.landmark_fn = ppipe.landmark_fn = template_landmarks
    jpipe.face_presence = ppipe.face_presence = lambda t, min_area_frac=2e-3: _bright(t)
    rng = np.random.default_rng(2)
    patterns = ([1, 0], [0, 1], [0, 0])
    batches = [(rng.uniform(size=(2, 96, 96, 3)) * 0.5 + 0.5 * np.asarray(p)[:, None, None, None]
                ).astype(np.float32) for p in patterns]
    try:
        j_state = p_state = None
        outs = []
        for frames, carry in zip(batches, (True, True, False)):
            j_out, j_state, j_quads = jpipe.swap_images_robust(
                jnp.asarray(frames), jnp.asarray(x["src"]), state=j_state if carry else None,
                one_program=one_program)
            p_out, p_state, p_quads = ppipe.swap_images_robust(
                frames, x["src"], state=p_state if carry else None, one_program=one_program)
            assert (p_state is None) == (j_state is None)
            assert isinstance(p_quads, np.ndarray) and p_quads.shape == (2, 4, 2)
            _close(p_quads, j_quads, ATOL)
            _close(p_out, j_out, PATH_TOL)
            outs.append(p_out)
    finally:
        jpipe.landmark_fn = ppipe.landmark_fn = None
        del jpipe.face_presence, ppipe.face_presence
    assert p_state is None and torch.equal(outs[2], torch.from_numpy(batches[2]))
    for b, i in ((0, 0), (0, 1), (1, 0), (1, 1)):  # every frame of A and B was swapped
        assert (outs[b][i] - torch.from_numpy(batches[b][i])).abs().max() > 0.1


def test_multiface_matches_jax(pipes):
    """detect_faces on the real parse, and on a parsing map forced to three
    face regions; landmarks_in_box on each padded box (LandmarkNet); then
    swap_frame_multiface on those boxes (one swap batch, sequential
    paste-back) with the host landmark_fn, as test_swap_images_matches_jax
    holds the whole path."""
    jpipe, ppipe, x = pipes
    frame = x["frame"]
    assert ppipe.detect_faces(frame, 3) == jpipe.detect_faces(frame, 3)
    seg = np.zeros((96, 128), np.int32)
    seg[10:40, 8:38] = 6
    seg[50:90, 60:100] = 6
    seg[8:38, 90:122] = 1
    j_parse, p_parse = jpipe.parse, ppipe._parse
    jpipe.parse = lambda im: jnp.asarray(seg)[None]
    ppipe._parse = lambda im: torch.from_numpy(seg)[None]
    try:
        boxes = ppipe.detect_faces(frame, max_faces=3)
        assert boxes == jpipe.detect_faces(frame, max_faces=3)
        assert boxes == [(60, 50, 100, 90), (90, 8, 122, 38), (8, 10, 38, 40)]
        for box in boxes:
            _close(ppipe.landmarks_in_box(frame, box), jpipe.landmarks_in_box(frame, box),
                   ATOL * 4)
        jpipe.parse, ppipe._parse = j_parse, p_parse  # the crops parse for real
        jpipe.landmark_fn = ppipe.landmark_fn = template_landmarks
        jpipe.detect_faces = lambda f, max_faces=4: boxes
        ppipe.detect_faces = lambda f, max_faces=4: boxes
        ref = np.asarray(jpipe.swap_frame_multiface(frame, jnp.asarray(x["src"][:1])))
        got = ppipe.swap_frame_multiface(frame, x["src"][:1])
    finally:
        jpipe.parse, ppipe._parse = j_parse, p_parse
        jpipe.landmark_fn = ppipe.landmark_fn = None
        for p in (jpipe, ppipe):
            p.__dict__.pop("detect_faces", None)
    assert got.shape == frame.shape
    assert np.abs(ref - frame).max() > 0.1
    _close(got, ref, PATH_TOL)


def test_connected_components_match_cv2(pipes):
    """detect_faces' 8-connected split (scipy.ndimage) against the
    cv2.connectedComponentsWithStats it replaces, on random masks with
    many components, diagonal joins and equal areas: the same boxes in the
    same order."""
    import cv2

    _, ppipe, _ = pipes
    rng = np.random.default_rng(5)
    p_parse = ppipe._parse
    try:
        for trial in range(4):
            face = (rng.uniform(size=(60, 80)) > 0.8).astype(np.uint8)
            face[5:9, 5:9] = 1
            face[20:24, 40:44] = 1  # two 4x4 blocks of equal area
            face[30, 30] = face[31, 31] = 1  # a diagonal join
            ppipe._parse = lambda im: torch.from_numpy(face.astype(np.int32) * 6)[None]
            got = ppipe.detect_faces(np.zeros((60, 80, 3), np.float32), max_faces=50,
                                     min_area_frac=0.0)
            num, _, stats, _ = cv2.connectedComponentsWithStats(face, 8)
            ref = sorted(((int(s[4]), (int(s[0]), int(s[1]), int(s[0] + s[2]), int(s[1] + s[3])))
                          for s in stats[1:num]), key=lambda t: -t[0])
            assert got == [b for _, b in ref[:50]], trial
    finally:
        ppipe._parse = p_parse
