"""The port's landmark trainer (reface_tpu_torch/cli/train_landmarks.py) and
its synthetic faces (data/synthetic.py::make_landmark_faces, drawn by
data/raster.py) against the JAX package's and cv2, on the CPU.

- make_landmark_faces: the landmarks bit-equal to the JAX function's (the
  same default_rng draws) and at least 97% of each image's pixels bit-equal
  to the cv2-drawn ones (reached: > 99.8% at 64 px, > 99.99% at 256 px,
  the sensor noise included; the rest are pixels at the edges of the thick
  strokes and of the head where the image border clips it).
- data/raster.py against cv2 on random shapes: thickness-1 lines and
  polylines, thickness-2 polylines away from the border, filled circles and
  unclipped fillPoly polygons bit-equal.
- One training step (the tiny LandmarkNet, fp32): the L1 loss within 1e-5
  relative, every gradient within test_torch_port_train's limits, and the
  AdamW update under the cosine schedule against optax.adamw's.
- The driver: converges below the mean-shape baseline on held-out faces
  (tests/test_landmark_stack.py's JAX test, on the port), its file loads
  through cli.common.build_raw_pipeline's --landmark-ckpt, its report lines
  are the JAX driver's word for word (numbers and paths aside), and the
  --rert label mode reports both errors.
"""

import contextlib
import io
import re
from types import SimpleNamespace

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_helpers import init_jax, nchw, one_torch_thread

from reface_tpu.cli import train_landmarks as j_cli
from reface_tpu.data.synthetic import LANDMARK68_TEMPLATE as J_TEMPLATE
from reface_tpu.data.synthetic import make_landmark_faces as j_faces
from reface_tpu.nn.landmarks import LandmarkNet as JNet
from reface_tpu.nn.landmarks import LandmarkNetConfig as JNetConfig
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.cli import train_landmarks as p_cli
from reface_tpu_torch.data import raster
from reface_tpu_torch.data.synthetic import LANDMARK68_TEMPLATE as P_TEMPLATE
from reface_tpu_torch.data.synthetic import make_landmark_faces as p_faces
from reface_tpu_torch.nn.landmarks import LandmarkNet
from reface_tpu_torch.pipelines.train import AdamW, cosine_decay_schedule

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.mark.parametrize("size,n", [(64, 24), (256, 6)])
def test_landmark_faces_match_jax(size, n):
    """Landmarks and template bit-equal; each image >= 97% bit-equal."""
    pi, pl = p_faces(n, size=size, seed=5)
    ji, jl = j_faces(n, size=size, seed=5)
    np.testing.assert_array_equal(P_TEMPLATE, J_TEMPLATE)
    np.testing.assert_array_equal(pl, jl)
    assert pi.shape == ji.shape and pi.dtype == np.uint8
    share = (pi == ji).all(-1).reshape(n, -1).mean(1)
    assert share.min() >= 0.97, share


def _polygon(r, s):
    n = int(r.integers(3, 30))
    c = r.uniform(20, s - 20, 2)
    rad = r.uniform(0.2, 1.0, n) * min(c.min(), s - 1 - c.max())  # inside the image
    ang = np.sort(r.uniform(0, 2 * np.pi, n))
    return np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)], 1).round().astype(
        np.int32)


_SHAPES = {
    "line1": (lambda im, r: cv2.line(im, *_ends(r), (200, 100, 50), 1),
              lambda im, r: raster.line(im, *_ends(r), (200, 100, 50), 1)),
    "polylines1": (lambda im, r: cv2.polylines(im, [_pts(r)], bool(r.integers(2)), (9, 9, 9), 1),
                   lambda im, r: raster.polylines(im, _pts(r), bool(r.integers(2)), (9, 9, 9), 1)),
    "polylines2": (lambda im, r: cv2.polylines(im, [_pts(r, 8)], bool(r.integers(2)), (9, 9, 9), 2),
                   lambda im, r: raster.polylines(im, _pts(r, 8), bool(r.integers(2)), (9, 9, 9),
                                                  2)),
    "circle": (lambda im, r: cv2.circle(im, _center(r), int(r.integers(0, 30)), (1, 2, 3), -1),
               lambda im, r: raster.circle(im, _center(r), int(r.integers(0, 30)), (1, 2, 3))),
    "fill_poly": (lambda im, r: cv2.fillPoly(im, [_polygon(r, 128)], (7, 8, 9)),
                  lambda im, r: raster.fill_poly(im, _polygon(r, 128), (7, 8, 9))),
}


def _ends(r):
    p = r.integers(-10, 138, 4)
    return (int(p[0]), int(p[1])), (int(p[2]), int(p[3]))


def _pts(r, margin=0):
    """Vertices at least `margin` px inside the image (a thick stroke whose
    quad the border clips can differ from cv2's by a pixel)."""
    return r.integers(margin, 128 - margin, (int(r.integers(2, 12)), 2)).astype(np.int32)


def _center(r):
    return tuple(int(v) for v in r.integers(-3, 131, 2))


@pytest.mark.parametrize("kind", sorted(_SHAPES))
def test_raster_matches_cv2(kind):
    """100 random shapes of a kind on a 128 px image, bit-equal to cv2's."""
    draw_cv, draw_np = _SHAPES[kind]
    for k in range(100):
        a = np.zeros((128, 128, 3), np.uint8)
        b = a.copy()
        draw_cv(a, np.random.default_rng(k))
        draw_np(b, np.random.default_rng(k))
        assert np.array_equal(a, b), (kind, k)


def test_cosine_schedule_matches_optax():
    """cosine_decay_schedule against optax's, fp32: 1e-7 relative."""
    ref = optax.cosine_decay_schedule(3e-4, 100)
    got = cosine_decay_schedule(3e-4, 100)
    for c in (0, 1, 37, 99, 100, 250):
        assert abs(got(c) - float(ref(c))) <= 1e-7 * 3e-4, c


def test_landmark_step_matches_jax():
    """One step of the tiny LandmarkNet at 64 px from the same weights and
    batch: the L1 loss in pixels within 1e-5 relative, every gradient within
    1e-4 relative L2 of the larger of its norm and 1e-3 of the whole's, and
    the AdamW (cosine schedule, weight decay 1e-4) update within 1e-4
    relative L2 of optax's over the elements whose gradient is above 1e-5
    of the largest (a first Adam step moves a weight by about lr * sign(g))."""
    jcfg = JNetConfig(widths=(8, 16, 32, 32), input_size=64, dtype=jnp.float32)
    jnet = JNet(jcfg)
    params = init_jax(jnet, jnp.zeros((1, 64, 64, 3)), seed=2)
    imgs, lms = p_faces(8, size=64, seed=3)
    x = imgs.astype(np.float32) / 127.5 - 1.0
    y = lms.reshape(8, -1)

    def loss_fn(p):
        return jnp.mean(jnp.abs(jnet.apply(p, jnp.asarray(x)) - jnp.asarray(y)))

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.adamw(optax.cosine_decay_schedule(3e-3, 50))
    upd, _ = tx.update(jg, tx.init(params), params)
    jnew = optax.apply_updates(params, upd)

    net = LandmarkNet(p_cli.tiny_landmark_config(64), device="cpu", param_dtype=torch.float32)
    net.load_state_dict(from_jax.landmark_net_from_jax(params))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    opt = p_cli.landmark_optimizer(net, 3e-3, 50)
    assert isinstance(opt, AdamW) and opt.weight_decay == 1e-4
    grads = {}
    step = opt.step
    opt.step = lambda gs: grads.update(zip(opt.names, gs)) or step(gs)
    loss = p_cli.make_landmark_step(net, opt)(nchw(x), torch.from_numpy(y))
    assert abs(loss.item() / float(jl) - 1) < 1e-5
    ref = {k: v.numpy() for k, v in from_jax.landmark_net_from_jax(
        jax.tree.map(np.asarray, jg)).items()}
    total = np.sqrt(sum(np.sum(r.astype(np.float64) ** 2) for r in ref.values()))
    for k, g in grads.items():
        diff = np.linalg.norm(g.numpy().astype(np.float64) - ref[k])
        assert diff <= 1e-4 * max(np.linalg.norm(ref[k]), 1e-3 * total), k
    new = from_jax.landmark_net_from_jax(jax.tree.map(np.asarray, jnew))
    floor = 1e-5 * max(float(g.abs().max()) for g in grads.values())
    for k, v in net.state_dict().items():
        live = (grads[k].abs() > floor).numpy()
        a, b = (v - before[k]).numpy()[live], (new[k] - before[k]).numpy()[live]
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), k


def _report(lines: str, out: str) -> list:
    """The report lines with numbers and the output path masked."""
    return [re.sub(r"\d+(\.\d+)?", "#", ln.replace(out, "OUT"))
            for ln in lines.splitlines() if ln.startswith("[lm]")]


def test_cli_converges_loads_and_reports(tmp_path, capsys):
    """tests/test_landmark_stack.py's convergence setting on the port: 72
    faces at 64 px, 220 steps, the held-out px error under the mean-shape
    baseline; the file loads through build_raw_pipeline's --landmark-ckpt
    (tiny_raw_config's LandmarkNet); the report lines are the JAX driver's
    (run for 3 steps on the same data)."""
    from reface_tpu_torch.cli.common import build_raw_pipeline
    from reface_tpu_torch.pipelines.raw import tiny_raw_config
    from reface_tpu_torch.pipelines.swap import FaceSwapper, tiny_swap_config

    imgs, lms = p_faces(72, size=64, seed=2)
    npz = str(tmp_path / "lm.npz")
    np.savez(npz, images=imgs, landmarks=lms)
    out = str(tmp_path / "lm.pt")
    net = p_cli.main(["--data", npz, "--out", out, "--steps", "220", "--batch-size", "16",
                      "--lr", "3e-3", "--val-frac", "0.12", "--log-every", "100", "--tiny",
                      "--device", "cpu"])
    text = capsys.readouterr().out
    val = slice(64, 72)
    with torch.no_grad():
        pred = net(nchw(imgs[val].astype(np.float32) / 127.5 - 1.0)).numpy().reshape(-1, 68, 2)
    err = np.sqrt(((pred - lms[val]) ** 2).sum(-1)).mean()
    base = np.sqrt(((lms[:64].mean(0)[None] - lms[val]) ** 2).sum(-1)).mean()
    assert np.isfinite(err) and err < base
    assert f"[lm] val mean px error vs labels @64px: {err:.2f} (n=8)" in text

    pipe = build_raw_pipeline(SimpleNamespace(landmark_ckpt=out),
                              FaceSwapper(tiny_swap_config(64), device="cpu"), tiny_raw_config())
    for k, v in pipe.landmark_net.state_dict().items():
        assert torch.equal(v, net.state_dict()[k]), k

    jout = str(tmp_path / "jax_ckpt")
    j_cli.main(["--data", npz, "--out", jout, "--steps", "3", "--batch-size", "16",
                "--val-frac", "0.12", "--log-every", "1", "--tiny", "--backend", "cpu"])
    jtext = capsys.readouterr().out
    p_cli.main(["--data", npz, "--out", out, "--steps", "3", "--batch-size", "16",
                "--val-frac", "0.12", "--log-every", "1", "--tiny", "--device", "cpu"])
    assert _report(capsys.readouterr().out, out) == _report(jtext, jout)


def test_cli_rert_label_mode(tmp_path):
    """--rert: the labels come from the native ERT over the npz's images; the
    report gives the CNN's error against the ERT and against the npz's
    landmarks, with the JAX driver's words."""
    from test_landmark_stack import _write_rert

    rert, _ = _write_rert(tmp_path)
    imgs, lms = p_faces(24, size=64, seed=4)
    npz = str(tmp_path / "lm.npz")
    np.savez(npz, images=imgs, landmarks=lms)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        p_cli.main(["--data", npz, "--out", str(tmp_path / "lm.pt"), "--steps", "12",
                    "--batch-size", "8", "--val-frac", "0.2", "--log-every", "10", "--tiny",
                    "--device", "cpu", "--rert", rert])
    text = buf.getvalue()
    assert f"[lm] labels: native ERT over 24 crops ({rert})" in text
    assert "[lm] val mean px error vs ERT @64px: " in text
    assert re.search(r"\[lm\] val mean px error vs GT @64px: [\d.]+ \(teacher ERT vs GT: "
                     r"[\d.]+\)", text)
