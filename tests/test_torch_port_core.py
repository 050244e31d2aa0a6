"""reface_tpu_torch core numerics and resizes against the JAX package,
plus the port's isolation from JAX and its refusal to fall back to the CPU.

The resizes and pooling are in test_torch_port_resize.py.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import nhwc
from test_torch_port_helpers import one_torch_thread

from reface_tpu.core import schedules as JS
from reface_tpu.core.distributions import DiagonalGaussian as JGauss
from reface_tpu_torch.core import schedules as PS
from reface_tpu_torch.core.distributions import DiagonalGaussian as PGauss

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedule_exact(kind):
    np.testing.assert_array_equal(PS.make_beta_schedule(kind),
                                  JS.make_beta_schedule(kind))


@pytest.mark.parametrize("steps,method", [(50, "uniform"), (4, "uniform"),
                                          (30, "quad")])
def test_ddim_tables_exact(steps, method):
    """Tables equal the JAX package's exactly (float64 math, f32 storage)."""
    js, ps = JS.DiffusionSchedule.create(), PS.DiffusionSchedule.create()
    for f in ("betas", "alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
              "posterior_log_variance_clipped", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                      np.asarray(getattr(js, f)))
    jt = JS.DDIMTables.create(js, steps, eta=0.5, method=method)
    pt = PS.DDIMTables.create(ps, steps, eta=0.5, method=method)
    for f in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas",
              "sigmas"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    if (steps, method) == (50, "uniform"):
        assert pt.timesteps[0] == 1 and pt.timesteps[-1] == 981


def test_q_sample_and_timestep_embedding():
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, 4, 8, 8)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([1, 500, 999])
    js, ps = JS.DiffusionSchedule.create(), PS.DiffusionSchedule.create()
    ref = js.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = ps.q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                      torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    for dim in (320, 33):
        ref = np.asarray(JS.timestep_embedding(jnp.asarray(t), dim))
        got = PS.timestep_embedding(torch.from_numpy(t), dim).numpy()
        # XLA's and torch's fp32 exp differ by up to one ulp (~6e-8) on a
        # few frequencies; the argument t*freq then moves by up to ~t*6e-8,
        # so the bound is 1e-6 plus twice that (5.7e-5 seen at t=999, 0 at t=1)
        bound = 1e-6 + 1.2e-7 * t[:, None].astype(np.float64)
        assert (np.abs(got - ref) <= bound).all()
        np.testing.assert_allclose(got[0], ref[0], atol=1e-6, rtol=0)


def test_diagonal_gaussian():
    rng = np.random.default_rng(1)
    mom = (rng.normal(size=(2, 8, 4, 4)) * 30).astype(np.float32)
    p = PGauss.from_moments(torch.from_numpy(mom), dim=1)
    j = JGauss.from_moments(jnp.asarray(mom.transpose(0, 2, 3, 1)), axis=-1)
    np.testing.assert_array_equal(nhwc(p.mode()), np.asarray(j.mode()))
    np.testing.assert_array_equal(nhwc(p.logvar), np.asarray(j.logvar))
    assert float(p.logvar.max()) == 20.0 and float(p.logvar.min()) == -30.0
    g = torch.Generator().manual_seed(0)
    s = p.sample(g)
    z = (s - p.mean) / p.std
    assert s.shape == p.mean.shape and torch.isfinite(z).all()


def test_port_imports_no_jax():
    """The port imports neither jax nor reface_tpu, nor cv2 or PIL, which
    it does not depend on (fresh interpreter), orbax neither."""
    code = (
        "import sys\n"
        "import reface_tpu_torch, reface_tpu_torch.pipelines.swap, "
        "reface_tpu_torch.pipelines.train, reface_tpu_torch.core.ema, "
        "reface_tpu_torch.core.lr_schedule, reface_tpu_torch.ops.attention, "
        "reface_tpu_torch.ckpt.from_jax, reface_tpu_torch.ops.kernels, "
        "reface_tpu_torch.diffusion.losses, reface_tpu_torch.nn.lpips, "
        "reface_tpu_torch.nn.landmarks, reface_tpu_torch.pipelines.raw, "
        "reface_tpu_torch.nn.bisenet, reface_tpu_torch.preprocess.align, "
        "reface_tpu_torch.preprocess.detect, reface_tpu_torch.preprocess.masks, "
        "reface_tpu_torch.native_ops, reface_tpu_torch.cli.common, "
        "reface_tpu_torch.cli.swap, reface_tpu_torch.cli.demo_server, "
        "reface_tpu_torch.ckpt.from_torch, reface_tpu_torch.core.config, "
        "reface_tpu_torch.io.images, reface_tpu_torch.nn.safety, "
        "reface_tpu_torch.eval, reface_tpu_torch.eval.backbones, "
        "reface_tpu_torch.eval.fid, reface_tpu_torch.eval.id_retrieval, "
        "reface_tpu_torch.eval.pose, reface_tpu_torch.eval.expression, "
        "reface_tpu_torch.eval.protocol, reface_tpu_torch.data, "
        "reface_tpu_torch.data.augment, reface_tpu_torch.data.test_bench, "
        "reface_tpu_torch.data.loader, reface_tpu_torch.cli.evaluate, "
        "reface_tpu_torch.cli.inference_test_bench, reface_tpu_torch.cli.train, "
        "reface_tpu_torch.cli.prepare_data, reface_tpu_torch.data.celeba, "
        "reface_tpu_torch.data.ffhq, reface_tpu_torch.data.synthetic, "
        "reface_tpu_torch.ckpt.io, reface_tpu_torch.core.profiling, "
        "reface_tpu_torch.diffusion.guidance, reface_tpu_torch.diffusion.ddim_guided, "
        "reface_tpu_torch.preprocess.tps, reface_tpu_torch.preprocess.priors, "
        "reface_tpu_torch.diffusion.distill, reface_tpu_torch.cli.distill, "
        "reface_tpu_torch.diffusion.vae_loss, reface_tpu_torch.nn.discriminator, "
        "reface_tpu_torch.cli.train_vae, reface_tpu_torch.cli.train_landmarks, "
        "reface_tpu_torch.data.raster, reface_tpu_torch.data.video, "
        "reface_tpu_torch.io.video, reface_tpu_torch.cli.video_swap, "
        "reface_tpu_torch.ops.separable\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'orbax', 'reface_tpu', 'cv2', 'PIL')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_silent_cpu(monkeypatch):
    """device=None means CUDA; without a card the swapper and the raw
    pipeline raise."""
    from reface_tpu_torch.pipelines.raw import RawSwapPipeline, tiny_raw_config
    from reface_tpu_torch.pipelines.swap import FaceSwapper, tiny_swap_config

    cpu_swapper = FaceSwapper(tiny_swap_config(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaceSwapper(tiny_swap_config(), device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RawSwapPipeline(cpu_swapper, tiny_raw_config(), device=None)
    with pytest.raises(ValueError, match="not its swapper's"):
        RawSwapPipeline(cpu_swapper, tiny_raw_config(), device="cuda")
