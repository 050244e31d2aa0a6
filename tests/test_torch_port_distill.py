"""The port's step-count distillation (reface_tpu_torch.diffusion.distill)
against the JAX package's (reface_tpu.diffusion.distill), on the CPU.

The plan, the closed-form target and the teacher window (on a toy eps model
written in both packages, so that the window's index logic is held exactly,
the clamp below index 0 included), then the whole loss and the student's
gradient with the tiny UNet (tiny_swap_config(64)'s, einsum attention, fp32)
and the JAX draws handed to the port, fold_cfg on and off. Weights are
carried across by reface_tpu_torch.ckpt.from_jax, gradients compared by name.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import one_torch_thread, random_tree

from reface_tpu.core.schedules import DDIMTables as JTables
from reface_tpu.core.schedules import DiffusionSchedule as JSchedule
from reface_tpu.diffusion import distill as JD
from reface_tpu.nn.unet import UNetModel as JUNet
from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.core.schedules import DDIMTables as PTables
from reface_tpu_torch.core.schedules import DiffusionSchedule as PSchedule
from reface_tpu_torch.diffusion import distill as PD
from reface_tpu_torch.nn.unet import UNetModel as PUNet
from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

B, HW = 2, 8  # batch, latent side (64 px)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("start,target", [(50, 10), (50, 5), (50, 25), (40, 10), (12, 3)])
def test_schedule_plan_matches_jax(start, target):
    """distill_schedule_plan is the JAX function's, (50, 10) -> [10] and
    (50, 5) -> [25, 5] among them; steps_per_call refuses a non-divisor."""
    assert PD.distill_schedule_plan(start, target) == JD.distill_schedule_plan(start, target)
    assert PD.distill_schedule_plan(50, 10) == [10]
    assert PD.distill_schedule_plan(50, 5) == [25, 5]
    assert PD.DistillConfig(50, 10).steps_per_call == 5
    with pytest.raises(ValueError, match="must divide"):
        PD.DistillConfig(50, 15).steps_per_call


def _toy_j(x9, t, ctx):
    """An eps model in both packages' arithmetic: each channel a different
    function of the input, the timestep and the context."""
    w = jnp.linspace(0.5, 1.5, 9)
    h = jnp.tanh(x9 * w + (t.astype(jnp.float32) / 1000.0)[:, None, None, None])
    return h[..., :4] * h[..., 4:8] + jnp.mean(ctx, axis=(1, 2))[:, None, None, None]


def _toy_p(x9, t, ctx):
    w = torch.linspace(0.5, 1.5, 9).reshape(1, 9, 1, 1)
    h = torch.tanh(x9 * w + (t.float() / 1000.0)[:, None, None, None])
    return h[:, :4] * h[:, 4:8] + torch.mean(ctx, dim=(1, 2))[:, None, None, None]


@pytest.mark.parametrize("cfg_scale", [3.0, 1.0])
def test_teacher_window_matches_jax(cfg_scale):
    """k = 5 teacher steps from per-sample start indices, one of them 2 (so
    that three of its steps clamp below index 0 to the identity step), with
    CFG by batch doubling (scale 3) and without (scale 1): within 2e-6 max
    abs of the JAX window (fp32, the same operations in the same order)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, HW, HW, 4)).astype(np.float32)
    rest = rng.normal(size=(3, HW, HW, 5)).astype(np.float32)
    ctx, uctx = (rng.normal(size=(3, 1, 16)).astype(np.float32) for _ in range(2))
    j_hi = np.array([49, 2, 25], np.int32)
    want = JD.teacher_window(_toy_j, jnp.asarray(x), jnp.asarray(rest), jnp.asarray(j_hi), 5,
                             JTables.create(JSchedule.create(), 50), jnp.asarray(ctx),
                             jnp.asarray(uctx), cfg_scale)
    got = PD.teacher_window(_toy_p, _nchw(x), _nchw(rest), torch.from_numpy(j_hi).long(), 5,
                            PTables.create(PSchedule.create(), 50), torch.from_numpy(ctx),
                            torch.from_numpy(uctx), cfg_scale)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-6, rtol=0)
    # the clamped sample: steps at indices 2, 1, 0 and two identity steps,
    # the same as a window of 3 (the identity step recomputes x from its
    # pred_x0 and eps: 1e-6 of rounding)
    three = PD.teacher_window(_toy_p, _nchw(x)[1:2], _nchw(rest)[1:2],
                              torch.tensor([2]), 3, PTables.create(PSchedule.create(), 50),
                              torch.from_numpy(ctx)[1:2], torch.from_numpy(uctx)[1:2],
                              cfg_scale)
    torch.testing.assert_close(got[1:2], three, atol=1e-6, rtol=0)


def test_eps_target_matches_jax():
    """distill_eps_target: one eta=0 DDIM step with eps* lands on x_end
    (1e-5 fp32), and the value is the JAX function's (1e-6)."""
    rng = np.random.default_rng(1)
    x, x_end = (rng.normal(size=(2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    a_t = np.array([0.3, 0.6], np.float32).reshape(2, 1, 1, 1)
    a_tgt = np.array([0.5, 0.9], np.float32).reshape(2, 1, 1, 1)
    want = JD.distill_eps_target(*map(jnp.asarray, (x, x_end, a_t, a_tgt)))
    got = PD.distill_eps_target(*map(torch.from_numpy, (x, x_end, a_t, a_tgt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    from reface_tpu_torch.diffusion.ddim import ddim_step

    a_t_, a_tgt_ = torch.from_numpy(a_t), torch.from_numpy(a_tgt)
    x_prev, _ = ddim_step(torch.from_numpy(x), got, a_t_, a_tgt_, torch.sqrt(1 - a_t_), 0.0)
    np.testing.assert_allclose(x_prev.numpy(), x_end, atol=1e-5, rtol=0)


def test_make_distill_draws():
    """The draws' layout: i in [0, student_steps), noise (B, h, w, 4) NHWC."""
    cfg = PD.DistillConfig(teacher_steps=50, student_steps=10)
    d = PD.make_distill_draws(64, 8, cfg, "cpu", torch.Generator().manual_seed(0))
    assert d["i"].shape == (64,) and 0 <= int(d["i"].min()) and int(d["i"].max()) < 10
    assert d["noise"].shape == (64, 8, 8, 4)


@pytest.fixture(scope="module")
def unets():
    """The tiny UNet (einsum attention) in both packages: a teacher and a
    student with different random weights, and the loss's inputs."""
    jcfg = dataclasses.replace(j_tiny(64).unet, attn_impl="einsum")
    pcfg = dataclasses.replace(p_tiny(64).unet, attn_impl="einsum")
    shapes = jax.eval_shape(lambda k: JUNet(jcfg).init(
        k, jnp.zeros((1, HW, HW, 9)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, 768))),
        jax.random.key(0))
    teacher, student = random_tree(shapes, seed=1), random_tree(shapes, seed=2)
    rng = np.random.default_rng(3)
    inputs = dict(z0=rng.normal(size=(B, HW, HW, 4)).astype(np.float32),
                  rest=rng.normal(size=(B, HW, HW, 5)).astype(np.float32),
                  c=rng.normal(size=(B, 1, 768)).astype(np.float32),
                  uc=rng.normal(size=(B, 1, 768)).astype(np.float32))

    def port(tree):
        m = PUNet(pcfg, device="cpu")
        m.load_state_dict(from_jax.unet_from_jax(tree))
        return m

    return JUNet(jcfg), teacher, student, port(teacher).requires_grad_(False), port(student), inputs


@pytest.mark.parametrize("fold", [True, False])
def test_distill_loss_and_grad_match_jax(unets, fold):
    """The loss (teacher 4 steps, student 2: windows of 2 with CFG 3) and
    every student gradient against jax.value_and_grad of the JAX loss_fn,
    from the JAX draws of one key handed to the port, fold_cfg on (the
    student unguided) and off (the student under CFG too). fp32 both sides:
    the loss within 1e-5 relative, each gradient within 1e-4 relative L2 of
    the larger of its own norm and 1e-3 of the whole (test_torch_port_train's
    limits)."""
    jmod, teacher, student, p_teacher, p_student, inp = unets
    cfg = dict(teacher_steps=4, student_steps=2, cfg_scale=3.0, fold_cfg=fold)
    j_loss_fn, _, _ = JD.make_distill_loss(JD.DistillConfig(**cfg))
    key = jax.random.key(7)
    k_i, k_n = jax.random.split(key)
    draws = {"i": np.array(jax.random.randint(k_i, (B,), 0, 2)),
             "noise": np.array(jax.random.normal(k_n, (B, HW, HW, 4), jnp.float32))}
    assert set(draws["i"].tolist()) == {0, 1}  # the last window and an inner one

    def j_loss(sp):
        return j_loss_fn(lambda x9, t, c: jmod.apply(sp, x9, t, c),
                         lambda x9, t, c: jmod.apply(teacher, x9, t, c),
                         *(jnp.asarray(inp[k]) for k in ("z0", "rest", "c", "uc")), key)

    (jl, jm), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(student)

    p_loss_fn, tt, ts = PD.make_distill_loss(PD.DistillConfig(**cfg))
    assert torch.equal(ts.timesteps, tt.timesteps[::2])
    loss, m = p_loss_fn(p_student, p_teacher, _nchw(inp["z0"]), _nchw(inp["rest"]),
                        torch.from_numpy(inp["c"]), torch.from_numpy(inp["uc"]), draws)
    assert abs(loss.item() / float(jl) - 1) < 1e-5
    assert abs(m["eps_mse"].item() / float(jm["eps_mse"]) - 1) < 1e-5
    params = dict(p_student.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    ref = {k: v.numpy() for k, v in from_jax.unet_from_jax(jax.tree.map(np.asarray, jg)).items()}
    total = np.sqrt(sum(np.sum(r.astype(np.float64) ** 2) for r in ref.values()))
    unused = 0
    for (name, _), g in zip(params.items(), grads):
        if g is None:  # the single-token cross-attention's to_q, to_k, norm2
            assert not np.any(ref[name]), name
            assert any(f".{k}." in name for k in ("attn2.to_q", "attn2.to_k", "norm2")), name
            unused += 1
            continue
        diff = np.linalg.norm(g.numpy().astype(np.float64) - ref[name])
        assert diff <= 1e-4 * max(np.linalg.norm(ref[name]), 1e-3 * total), name
    assert unused < 0.15 * len(params)
    assert all(p.grad is None for p in p_teacher.parameters())
