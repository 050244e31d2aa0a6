"""The port's VAE trainer driver (reface_tpu_torch/cli/train_vae.py) on the
CPU at its --tiny width: the image folder read as the JAX driver reads it
(PIL's decode and BILINEAR resize, bit for bit), R2, the files and report
lines of a run, metrics.jsonl's keys against the JAX step's, the LPIPS
flags and the --vae-ckpt readers.

R2 (a fault of the JAX reference, not copied): the JAX _load_images globs
lowercase extensions only (reface_tpu/cli/train_vae.py:31-33), so it skips
a.JPG and b.PNG; the port reads png, jpg and jpeg whatever their case.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_helpers import one_torch_thread

from reface_tpu.cli import train_vae as j_cli
from reface_tpu.diffusion import vae_loss as JL
from reface_tpu.nn.vae import AutoencoderKL as JVAE
from reface_tpu.nn.vae import VAEConfig as JVAEConfig
from reface_tpu_torch.ckpt import io as ckpt_io
from reface_tpu_torch.cli import train_vae as p_cli
from reface_tpu_torch.nn.lpips import LPIPS
from reface_tpu_torch.nn.vae import AutoencoderKL
from reface_tpu_torch.pipelines.swap import init_params

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

SIZE = 64


def _photo(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 / w, y * 255 / h, (x + y) * 127 / (h + w)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Lowercase files of several kinds and sizes (written by PIL): RGB
    JPEG and PNG, a gray PNG, an RGBA PNG, a .jpeg; a text file to skip."""
    d = tmp_path_factory.mktemp("images")
    Image.fromarray(_photo(0, 100, 80)).save(d / "a.jpg", quality=90)
    Image.fromarray(_photo(1, 40, 50)).save(d / "b.png")
    Image.fromarray(_photo(2, 64, 64)[..., 0]).save(d / "c.png")
    Image.fromarray(np.dstack([_photo(3, 90, 120), np.full((90, 120), 200, np.uint8)])).save(
        d / "d.png")
    Image.fromarray(_photo(4, 300, 260)).save(d / "e.jpeg", quality=95)
    (d / "notes.txt").write_text("not an image")
    return d


def test_load_images_matches_jax(folder):
    """The lowercase folder: the port's _load_images bit-equal to the JAX
    driver's (PIL), the order and --max-images' cut included."""
    for limit in (0, 3):
        want = j_cli._load_images(str(folder), SIZE, limit=limit)
        got = p_cli._load_images(str(folder), SIZE, limit=limit)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_load_images_reads_uppercase_extensions(folder, tmp_path):
    """R2: a.JPG and b.PNG (copies of lowercase files) are read by the port,
    in sorted order, equal to their lowercase twins, and skipped by the JAX
    driver; an empty folder is refused as the JAX driver refuses it."""
    for src, dst in (("a.jpg", "A.JPG"), ("b.png", "B.PNG")):
        (tmp_path / dst).write_bytes((folder / src).read_bytes())
    (tmp_path / "c.Jpeg").write_bytes((folder / "e.jpeg").read_bytes())
    with pytest.raises(SystemExit, match="no images in"):
        j_cli._load_images(str(tmp_path), SIZE)
    got = p_cli._load_images(str(tmp_path), SIZE)
    twins = [p_cli._load_images(str(folder), SIZE)[i] for i in (0, 1, 4)]
    assert got.shape == (3, SIZE, SIZE, 3)
    for a, b in zip(got, twins):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no images in"):
        p_cli._load_images(str(tmp_path / "empty"), SIZE)


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = p_cli.main(argv)
    return out, buf.getvalue()


def _tiny(folder, out, *extra):
    return ["--images", str(folder), "--out", str(out), "--tiny", "--device", "cpu",
            "--image-size", str(SIZE), "--batch-size", "2", "--log-every", "1", *extra]


def test_tiny_run_files_metrics_and_report(folder, tmp_path):
    """Two steps with --allow-random-lpips and the gate open from step 1:
    <out>/vae and <out>/disc (ckpt/io.py's params files), metrics.jsonl a
    row a step with the keys of the JAX step's logs (jax.eval_shape of its
    step_fn) plus step and wall_s, d_weight 0 at step 0 and positive at step
    1, timing.jsonl a line a step, and the JAX driver's report lines."""
    out = tmp_path / "run"
    state, text = _run(_tiny(folder, out, "--allow-random-lpips", "--steps", "2",
                             "--disc-start", "1"))
    vae_sd, disc_sd = (ckpt_io.load_params(str(out / n)) for n in ("vae", "disc"))
    assert set(vae_sd) == {"vae"} and set(disc_sd) == {"disc"}
    assert all(torch.equal(v, vae_sd["vae"][k]) for k, v in state.vae.state_dict().items())
    assert all(torch.equal(v, disc_sd["disc"][k]) for k, v in state.disc.state_dict().items())

    jvae = JVAE(JVAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1, dtype=jnp.float32))
    init_state, step_fn, _, lpips = JL.make_vae_train_step(jvae, JL.VAELossConfig(), jit=False)
    x = jnp.zeros((2, SIZE, SIZE, 3))
    vae_p = jax.eval_shape(lambda: jvae.init(jax.random.key(0), x))
    lp_p = jax.eval_shape(lambda: lpips.init(jax.random.key(0), x, x))
    jstate = jax.eval_shape(lambda p: init_state(p, jax.random.key(0), SIZE), vae_p)
    _, logs = jax.eval_shape(lambda s, p: step_fn(s, x, jax.random.key(1), p), jstate, lp_p)
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [set(r) for r in rows] == [set(logs) | {"step", "wall_s"}] * 2
    assert [r["step"] for r in rows] == [0, 1]
    assert rows[0]["d_weight"] == 0.0 and rows[1]["d_weight"] > 0.0
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert len((out / "timing.jsonl").read_text().splitlines()) == 2
    lines = text.splitlines()
    assert lines[:3] == ["[vae] fresh init (no --vae-ckpt)",
                         "[vae] WARNING: RANDOM LPIPS features — the perceptual term "
                         "is meaningless; pass --lpips-ckpt for real runs",
                         "[vae] 5 images @ 64px"]
    assert lines[3].startswith("[vae] step 0: ae ") and " disc " in lines[3]
    assert lines[-1] == f"[vae] saved {out}/vae (+disc)"


def test_lpips_flags(folder, tmp_path):
    """Without --lpips-ckpt or --allow-random-lpips the driver exits with the
    JAX driver's message; --lpips-ckpt reads a module dump."""
    with pytest.raises(SystemExit, match=r"pass --lpips-ckpt \(or --allow-random-lpips"):
        _run(_tiny(folder, tmp_path / "x", "--steps", "1"))
    path = tmp_path / "lpips.pth"
    torch.save(init_params(LPIPS(), seed=7).state_dict(), path)
    _, text = _run(_tiny(folder, tmp_path / "y", "--steps", "1", "--lpips-ckpt", str(path)))
    assert f"[vae] LPIPS weights loaded from {path}" in text


def test_vae_ckpt_readers(folder, tmp_path):
    """--vae-ckpt: a full checkpoint (the VAE under first_stage_model.,
    detected), a standalone dump, and the <out>/vae directory this driver
    wrote each start the VAE from their weights; a directory without
    params.pt (a JAX orbax tree) is refused with the converter's name."""
    vae = AutoencoderKL(p_cli.tiny_vae_config(), device="cpu")
    init_params(vae, seed=11)
    sd = vae.state_dict()
    full, alone = tmp_path / "full.ckpt", tmp_path / "vae.pth"
    torch.save({"state_dict": {**{f"first_stage_model.{k}": v for k, v in sd.items()},
                               "model.diffusion_model.x": torch.zeros(1)}}, full)
    torch.save(sd, alone)
    seen = {}
    from reface_tpu_torch.diffusion import vae_loss

    make = vae_loss.make_vae_train_step

    def spy(v, *a, **kw):
        seen["sd"] = {k: t.clone() for k, t in v.state_dict().items()}
        return make(v, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vae_loss, "make_vae_train_step", spy)
        for path, what in ((full, "prefix=first_stage_model."), (alone, "prefix=none")):
            _, text = _run(_tiny(folder, tmp_path / "o", "--steps", "1", "--allow-random-lpips",
                                 "--vae-ckpt", str(path)))
            assert f"[vae] read torch weights from {path} ({what})" in text
            assert all(torch.equal(seen["sd"][k], v) for k, v in sd.items())
        written = ckpt_io.load_params(str(tmp_path / "o" / "vae"))["vae"]
        _, text = _run(_tiny(folder, tmp_path / "o2", "--steps", "1", "--allow-random-lpips",
                             "--vae-ckpt", str(tmp_path / "o" / "vae")))
        assert f"[vae] loaded {tmp_path / 'o' / 'vae'}" in text
        assert all(torch.equal(seen["sd"][k], v) for k, v in written.items())
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    with pytest.raises(SystemExit, match="jax_params_to_torch"):
        _run(_tiny(folder, tmp_path / "o3", "--steps", "1", "--allow-random-lpips",
                   "--vae-ckpt", str(orbax)))
    assert os.path.isdir(tmp_path / "o2" / "disc")
