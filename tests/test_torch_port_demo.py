"""The port's demo server (reface_tpu_torch/cli/demo_server.py) and safety
checker (reface_tpu_torch/nn/safety.py) against the JAX package's.

The servers are driven through their real HTTP surface: bound to port 0,
a genuine multipart/form-data POST of PNG bytes, the PNG response decoded.
Both read the same tiny last.ckpt at --weights-dtype float32 with
sample_posterior=False, and each package's FaceSwapper.swap is patched at
run time to start from the same initial latent (the packages draw different
random numbers); the responses must agree within one level of 255.

The safety checkers run a tiny fp32 CLIP tower on the same diffusers-layout
state dict. The concept and special-care embeddings are placed at the
images' own embeddings, with thresholds that flag one image through a
concept, one only through the special-care +0.01, and none the third, each
with a margin far above fp32 rounding: the flags must be equal, the images
within 1e-4.
"""

import dataclasses
import io
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_cli_swap import COMMON, _fixed_latent
from test_torch_port_ckpt import _diffusers_safety, _lightning, _towers

from test_torch_port_helpers import one_torch_thread

from reface_tpu_torch.io.images import imdecode, imencode

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _multipart(fields):
    boundary = "testboundary7391"
    out = io.BytesIO()
    for name, data in fields.items():
        out.write(f"--{boundary}\r\n".encode())
        out.write(f'Content-Disposition: form-data; name="{name}"; filename="{name}.png"\r\n'
                  "Content-Type: image/png\r\n\r\n".encode())
        out.write(data)
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


def _post(server, body, ctype):
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/process_images", data=body,
            headers={"Content-Type": ctype}, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200 and resp.headers["Content-Type"] == "image/png"
            return resp.read()
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=60)
        assert not th.is_alive()


def test_demo_server_matches_the_jax_server(tmp_path, monkeypatch):
    """--precropped: the same upload answered within one level of the JAX
    server's PNG; the page, and a JSON 500 for a malformed POST."""
    from reface_tpu.cli.demo_server import make_server as j_make
    from reface_tpu.pipelines.swap import FaceSwapper as JSwapper
    from reface_tpu_torch.cli.demo_server import make_server as p_make
    from reface_tpu_torch.pipelines.swap import FaceSwapper as PSwapper

    ckpt = tmp_path / "last.ckpt"
    torch.save(_lightning(_towers(seed=21)), ckpt)
    x_T = np.random.default_rng(2).normal(size=(1, 8, 8, 4)).astype(np.float32)
    _fixed_latent(monkeypatch, JSwapper, x_T)
    _fixed_latent(monkeypatch, PSwapper, x_T)
    rng = np.random.default_rng(0)
    body, ctype = _multipart({
        "source": imencode(".png", rng.integers(0, 256, (72, 72, 3), dtype=np.uint8)),
        "target": imencode(".png", rng.integers(0, 256, (80, 80, 3), dtype=np.uint8))})
    args = ["--precropped", "--port", "0", "--ckpt", str(ckpt), *COMMON]
    want = imdecode(_post(j_make(["--backend", "cpu", *args]), body, ctype)).astype(int)
    server = p_make(["--device", "cpu", *args])
    got = imdecode(_post(server, body, ctype)).astype(int)
    assert got.shape == want.shape == (64, 64, 3)
    assert np.abs(got - want).max() <= 1
    assert np.abs(got - 127).max() > 20

    server = p_make(["--device", "cpu", *args])
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(url + "/", timeout=60) as resp:
            page = resp.read().decode()
        assert "multipart/form-data" in page and "process_images" in page
        req = urllib.request.Request(url + "/process_images", data=b"notmultipart",
                                     headers={"Content-Type": "text/plain"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 500 and "error" in e.value.read().decode()
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=60)
    assert not th.is_alive()


def test_fused_mode_and_letterbox():
    """--fused letterboxes each upload into --fused-frame and answers at the
    upload's own size; letterbox_frame equals the JAX one within 1e-5."""
    from reface_tpu.cli.demo_server import letterbox_frame as j_box
    from reface_tpu_torch.cli.demo_server import letterbox_frame as p_box
    from reface_tpu_torch.cli.demo_server import make_server

    img = np.random.default_rng(3).random((50, 100, 3)).astype(np.float32)
    for shape in ((50, 100, 3), (100, 50, 3)):
        x = np.ascontiguousarray(img.reshape(shape))
        (pp, pbox), (jp, jbox) = p_box(x, 64), j_box(x, 64)
        assert pbox == jbox
        np.testing.assert_allclose(pp, jp, atol=1e-5, rtol=0)
    rng = np.random.default_rng(1)
    body, ctype = _multipart({
        "source": imencode(".png", rng.integers(0, 256, (72, 72, 3), dtype=np.uint8)),
        "target": imencode(".png", rng.integers(0, 256, (80, 88, 3), dtype=np.uint8))})
    server = make_server(["--device", "cpu", "--tiny", "--fused", "--fused-frame", "96",
                          "--port", "0"])
    assert imdecode(_post(server, body, ctype)).shape == (80, 88, 3)


def test_safety_checker_matches_jax():
    from reface_tpu.ckpt.convert import convert_safety_checker
    from reface_tpu.nn.clip import CLIPVisionConfig as JCLIPConfig
    from reface_tpu.nn.clip import CLIPVisionTower as JTower
    from reface_tpu.nn.safety import SafetyChecker as JChecker
    from reface_tpu.nn.safety import SafetyCheckerConfig as JConfig
    from reface_tpu.pipelines.swap import clip_normalize as j_clip_normalize
    from reface_tpu_torch.ckpt.from_torch import safety_state_dict
    from reface_tpu_torch.nn.clip import CLIPVisionConfig
    from reface_tpu_torch.nn.safety import SafetyChecker, SafetyCheckerConfig

    kw = dict(hidden=64, layers=1, heads=4, patch=56, image_size=224)
    pcfg = SafetyCheckerConfig(clip=CLIPVisionConfig(**kw, dtype=torch.float32))
    jcfg = JConfig(clip=JCLIPConfig(**kw, dtype=jnp.float32))
    rng = np.random.default_rng(4)
    ramp = np.linspace(0, 1, 96, dtype=np.float32)
    images = np.stack([rng.random((96, 96, 3), np.float32),
                       np.broadcast_to(ramp[:, None, None], (96, 96, 3)),
                       np.broadcast_to(ramp[None, :, None] ** 2, (96, 96, 3))])
    sd = _diffusers_safety(pcfg, seed=1)
    shapes = jax.eval_shape(JTower(jcfg.clip).init, jax.random.key(0),
                            jnp.zeros((1, 224, 224, 3)))
    jp = convert_safety_checker(shapes, {k: v.numpy() for k, v in sd.items()})
    emb = np.array(JTower(jcfg.clip).apply(jp["tower"], j_clip_normalize(images)))
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    cos = emb @ emb.T
    # concept 0 at image 0, just above its threshold; concept 1 at image 1,
    # 0.005 short of it unless image 1's special-care hit adds 0.01; the
    # special-care embedding 0 at image 1; every other threshold out of reach
    margin = float(min(1 - cos[0, 1], 1 - cos[0, 2], 1 - cos[1, 2])) / 2
    assert margin > 2e-3, cos
    concepts = sd["concept_embeds"].clone()
    concepts[0], concepts[1] = torch.from_numpy(emb[0]), torch.from_numpy(emb[1])
    cthr = torch.full_like(sd["concept_embeds_weights"], 2.0)
    cthr[0], cthr[1] = 1 - margin, 1.005
    special = sd["special_care_embeds"].clone()
    special[0] = torch.from_numpy(emb[1])
    sthr = torch.full_like(sd["special_care_embeds_weights"], 2.0)
    sthr[0] = 1 - margin
    sd.update(concept_embeds=concepts, concept_embeds_weights=cthr,
              special_care_embeds=special, special_care_embeds_weights=sthr)
    jp = convert_safety_checker(shapes, {k: v.numpy() for k, v in sd.items()})
    want, want_flags = JChecker(jcfg, jp)(jnp.asarray(images))
    port = SafetyChecker(pcfg, safety_state_dict(sd, pcfg), device="cpu")
    got, flags = port(images)
    assert flags.tolist() == np.asarray(want_flags).tolist() == [True, True, False]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert np.abs(got.numpy()[0] - images[0]).max() > 0.1  # blurred
    np.testing.assert_array_equal(got.numpy()[2], images[2])
    # without weights: the pass-through of both packages
    out, none = SafetyChecker(pcfg, device="cpu")(images)
    assert not none.any() and np.array_equal(out.numpy(), images)
    assert dataclasses.asdict(pcfg)["n_concepts"] == 17
