"""The port's full training loss (reface_tpu_torch.diffusion.losses and the
recon path of pipelines.train) against the JAX package, on the CPU.

Tiny configs (tiny_swap_config(64), ReconLossConfig(ddim_steps=2,
lpips_scales=(1, 2))), fp32 on both sides, inputs from numpy seeds, JAX's own
draws reproduced from its split key and passed to the port; gradients are
compared by name through reface_tpu_torch.ckpt.from_jax. The landmark
auxiliary head's tests are in test_torch_port_losses_head.py.

The recon loss's pieces (timestep sequence, pooling, the keep mask, the ID
loss) are in test_torch_port_losses_recon.py; the DDIM reconstruction, the
VAE's remat and attention routing and the flash path at d=512 in
test_torch_port_losses_vae.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import (
    assert_close,
    check_full_loss_matches_jax,
    full_loss_setup,
    init_jax,
    jax_draws,
    load,
    nchw,
    one_torch_thread,
    port_full_step,
)

from reface_tpu.ckpt.convert import convert_lpips
from reface_tpu.nn.lpips import LPIPS as JLPIPS
from reface_tpu.pipelines import train as JT
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.nn.lpips import LPIPS
from reface_tpu_torch.pipelines import train as PT

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

# ------------------------------------------------------------------ modules

def test_lpips_matches_jax():
    """LPIPS distances at 64 px within 2e-5 of reface_tpu.nn.lpips (fp32; the
    AlexNet convs sum in another order), and the port's state dict goes back
    through the JAX package's convert_lpips to the same flax tree exactly."""
    rng = np.random.default_rng(0)
    x, y = (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    params = init_jax(JLPIPS(), jnp.asarray(x), jnp.asarray(y), seed=1)
    ref = JLPIPS().apply(params, jnp.asarray(x), jnp.asarray(y))
    sd = from_jax.lpips_from_jax(params)
    assert set(sd) == {f"net.layers.{i}.{w}" for i in (0, 3, 6, 8, 10)
                       for w in ("weight", "bias")} | {f"lin.{i}.1.weight" for i in range(5)}
    net = load(LPIPS(device="cpu"), sd)
    assert_close(net(nchw(x), nchw(y)), ref, atol=2e-5)
    back = convert_lpips(jax.eval_shape(lambda: params), {k: v.numpy() for k, v in sd.items()})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------ pieces


# ------------------------------------------------------------ the full loss


@pytest.fixture(scope="module")
def tiny():
    return full_loss_setup()


def test_full_loss_matches_jax(tiny):
    """The full loss (eps-MSE + the 2-step reconstruction with ID and LPIPS
    losses): loss, metrics and every trainable gradient against the JAX
    package; the frozen towers, LPIPS among them, get no gradient (the
    limits are in test_torch_port_helpers.check_full_loss_matches_jax; the
    landmark aux head is in test_torch_port_losses_head.py)."""
    check_full_loss_matches_jax(
        tiny, want_metrics={"loss_simple", "id_loss", "lpips_loss", "loss"},
        frozen={"vae", "conditioner", "lpips"})


@pytest.fixture(scope="module")
def monolith(tiny):
    _, params, batch, key = tiny
    draws = jax_draws(key, 2, 8, JT.TrainConfig())
    p = from_jax.swap_from_jax({k: v for k, v in params.items() if k != "landmark_head"})
    step, _, state = port_full_step(p)
    loss, metrics = step.loss_and_grads(state.modules, batch, draws)
    grads = {k: v.grad.clone() for k, v in PT.named_params(state.modules).items()
             if v.grad is not None}
    return p, batch, draws, loss, metrics, grads


@pytest.mark.parametrize("level", [1, 2])
def test_split_grad_matches_monolith(monolith, level):
    """split_grad 1 (recon backward, then eps backward) and 2 (the recon
    portion cut at the collected latents) leave the monolith's loss, metrics
    and gradients: 1e-6 relative (fp32; the same products, summed into .grad
    in another order)."""
    p, batch, draws, loss, metrics, grads = monolith
    step, _, state = port_full_step(p, PT.TrainConfig(split_grad=level))
    loss_s, metrics_s = step.loss_and_grads(state.modules, batch, draws)
    assert set(metrics_s) == set(metrics)
    assert abs(loss_s.item() / loss.item() - 1) < 1e-6
    for k, v in metrics.items():
        assert abs(metrics_s[k].item() / v.item() - 1) < 1e-6, k
    named = PT.named_params(state.modules)
    assert {k for k, v in named.items() if v.grad is not None} == set(grads)
    total = float(sum(g.double().pow(2).sum() for g in grads.values()) ** 0.5)
    for k, g in grads.items():
        diff = float((named[k].grad - g).norm())
        assert diff <= 1e-6 * max(float(g.norm()), 1e-3 * total), k


def test_full_train_step_updates_only_trainables(monolith):
    """One full-loss optimizer step: finite metrics, the trainables with a
    gradient move, the frozen towers (LPIPS among them) stay bit-identical."""
    p, batch, draws, *_ = monolith
    step, _, state = port_full_step(p, PT.TrainConfig(warmup_steps=1))
    before = {k: v.detach().clone() for k, v in PT.named_params(state.modules).items()}
    for _ in range(2):  # the warmup's first step has a learning rate of ~0
        state, metrics = step(state, batch, draws)
    assert all(torch.isfinite(v) for v in metrics.values())
    labels = PT.trainable_labels(before)
    assert "lpips" in state.params()
    for name, new in PT.named_params(state.modules).items():
        moved = not torch.equal(new, before[name])
        if labels[name] == "freeze":
            assert not moved, name
        elif new.grad is not None and new.grad.any():
            assert moved, name


# ------------------------------------------------------- flash plain, D = 512
