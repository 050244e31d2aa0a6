"""Shared helpers for the reface_tpu_torch parity tests (no tests here).

The JAX package is the reference. Its flax modules give the parameter
shapes through jax.eval_shape (tracing only: running the jitted flax init
would cost a compile of its own, 16 s for the tiny UNet on the CPU), and
every leaf is drawn from a numpy seed by its role. No leaf is zero: the
JAX init zero-initialises out_conv / proj_out, which would make an output
parity check vacuous. The tree is carried into the port through
reface_tpu_torch.ckpt.from_jax. Inputs come from a numpy seed and are fed
to both packages; comparisons are fp32 on the CPU. j_flash_residuals runs
the library flash forward with its saved row statistics, for the flash
attention tests of test_torch_port_train.py and
test_torch_port_attention_smalld.py.

The last part holds what the two files of full-loss tests share
(test_torch_port_losses.py and test_torch_port_losses_head.py: two files, so
that their two jits of the JAX loss's value_and_grad, ~50 s each, can run in
two workers).
"""

import functools
import os
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from reface_tpu.ops.attention import _flash_attention as j_flash_attention
from reface_tpu_torch.ops.attention import row_dot as port_row_dot

ATOL = 2e-4  # fp32 both sides; conv/gemm summation-order differences only


def j_flash_residuals(q, k, v, scale):
    """The library forward with save_residuals=True, padded and blocked as
    reface_tpu/ops/attention.py:_flash_attention calls it: (o, lse)."""
    from jax.experimental.pallas.ops.tpu import flash_attention as FA

    n, m, d = q.shape[2], k.shape[2], q.shape[3]
    pad = ((0, 0), (0, 0), (0, 0), (0, max(128, -(-d // 128) * 128) - d))
    q, k, v = (jnp.pad(t, pad) for t in (q, k, v))
    bq, bkv = min(512, n), min(1024, m)
    sizes = FA.BlockSizes(
        block_q=bq, block_k_major=bkv, block_k=bkv, block_b=1,
        block_q_major_dkv=bq, block_k_major_dkv=bkv, block_k_dkv=bkv,
        block_q_dkv=bq, block_k_major_dq=bkv, block_k_dq=bkv, block_q_dq=bq)
    o, l, mx = FA._flash_attention(q, k, v, None, None, True, False, scale,
                                   sizes, False)
    return o[..., :d], mx + jnp.log(l)


def random_tree(shapes, seed: int = 0):
    """numpy params for a tree of ShapeDtypeStructs, drawn by leaf name:
    kernels LeCun-normal, norm scales near 1, BatchNorm variances in
    [0.5, 1.5], PReLU slopes near 0.25, everything else N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = s.shape
        if name == "kernel":
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "scale":
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "alpha":
            a = 0.25 + rng.normal(0.0, 0.05, shape)
        else:
            a = rng.normal(0.0, 0.05, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def init_jax(module, *args, seed: int = 0, method=None):
    """Random numpy params of a flax module for inputs `args`."""
    kw = {"method": method} if method is not None else {}
    shapes = jax.eval_shape(lambda k, *a: module.init(k, *a, **kw),
                            jax.random.key(seed), *args)
    return random_tree(shapes, seed)


def nchw(a) -> torch.Tensor:
    """NHWC numpy -> NCHW float32 torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)
                                                 .transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def state_dict_np(module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def load(module, sd):
    """Strict load (every key of the port accounted for), frozen, eval."""
    module.load_state_dict(sd)
    return module.requires_grad_(False).eval()


def assert_close(port, ref, atol=ATOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), atol=atol, rtol=0)


def train_batch(b=2, size=64, seed=0):
    """A training batch in the JAX package's layout (NHWC numpy)."""
    rng = np.random.default_rng(seed)
    target = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    mask = (rng.uniform(size=(b, size, size, 1)) > 0.5).astype(np.float32)
    return dict(
        target_image=target,
        inpaint_image=target * mask,
        inpaint_mask=mask,
        ref_clip224=rng.normal(size=(b, 224, 224, 3)).astype(np.float32),
        landmarks=rng.uniform(0, size, (b, 136)).astype(np.float32),
    )


def jax_draws(key, b, hw, tcfg):
    """JAX prep's draws (reface_tpu/pipelines/train.py:219-245) from `key`,
    in the layout of the port's make_draws."""
    kt, kn, ke1, ke2, kd = jax.random.split(key, 5)
    shape = (b, hw, hw, 4)
    draws = {
        "t": jax.random.randint(kt, (b,), 0, tcfg.num_timesteps),
        "noise": jax.random.normal(kn, shape, jnp.float32),
        "eps_target": jax.random.normal(ke1, shape, jnp.float32),
        "eps_inpaint": jax.random.normal(ke2, shape, jnp.float32),
        "drop": (jax.random.uniform(kd, (b, 1, 1)) < tcfg.u_cond_percent).reshape(b),
    }
    return {k: np.array(v) for k, v in draws.items()}


# ------------------------------------------------- the full training loss

RECON_KW = dict(ddim_steps=2, lpips_scales=(1, 2))


PORT_NICE = 10  # the CPU priority of a worker's threads while a port module runs


def _may_restore_nice(old: int) -> bool:
    """Whether this process may lower its nice value back to `old`: as root,
    or where RLIMIT_NICE's ceiling (20 less its soft limit) reaches it."""
    soft = resource.getrlimit(resource.RLIMIT_NICE)[0]
    return os.geteuid() == 0 or soft == resource.RLIM_INFINITY or 20 - soft <= old


def _renice_threads(value: int) -> int:
    """Set the nice value of every thread of this process (XLA's pool
    included; Linux keeps one per thread); returns the main thread's old
    one."""
    old = os.getpriority(os.PRIO_PROCESS, 0)
    for tid in os.listdir("/proc/self/task"):
        try:
            os.setpriority(os.PRIO_PROCESS, int(tid), value)
        except (PermissionError, ProcessLookupError):
            pass
    return old


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module's tests (a test file imports this
    fixture and asks for it with `pytestmark`): tensors this small gain
    little from more (the two full-loss files took 3.9 CPU-minutes with one
    thread against 7.0 with eight, at the same wall time), and the suite's
    workers share the machine's cores. The worker's threads also run at
    PORT_NICE for the module: the port's CPU tests yield the cores to the
    JAX package's tests/test_train.py, whose worker sets the suite's length.
    A worker that could not lower its nice value again afterwards is left
    as it is, so that no later module of that worker runs at PORT_NICE."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    old = os.getpriority(os.PRIO_PROCESS, 0)
    renice = _may_restore_nice(old)
    if renice:
        _renice_threads(PORT_NICE)
    yield
    torch.set_num_threads(n)
    if renice:
        _renice_threads(old)


def full_loss_setup():
    """(JAX tiny_swap_config(64), random JAX params with the "lpips" and
    "landmark_head" trees, a batch, a key whose CFG dropout draws both a
    dropped and a kept sample)."""
    from reface_tpu.nn.landmarks import LandmarkAuxHead
    from reface_tpu.nn.lpips import LPIPS
    from reface_tpu.pipelines.swap import FaceSwapper, tiny_swap_config
    from reface_tpu.pipelines.train import TrainConfig
    from reface_tpu_torch.nn.unet import decoder_feature_shapes
    from reface_tpu_torch.pipelines.swap import tiny_swap_config as p_tiny

    jcfg = tiny_swap_config(image_size=64, ddim_steps=2)
    shapes = dict(jax.eval_shape(lambda k: FaceSwapper.init_params(jcfg, k),
                                 jax.random.key(0)))
    x = jnp.zeros((1, 64, 64, 3))
    shapes["lpips"] = jax.eval_shape(lambda k: LPIPS().init(k, x, x), jax.random.key(1))
    (c0, size), (c1, _) = decoder_feature_shapes(p_tiny(64).unet, 8)[-2:]
    shapes["landmark_head"] = jax.eval_shape(
        lambda k: LandmarkAuxHead().init(k, jnp.zeros((1, size, size, c0 + c1))),
        jax.random.key(2))
    # The landmark head ends in ReLU and a 2x2 max pool: where two values of
    # a window lie within fp32 rounding of each other the two packages may
    # pick different ones, and that one channel's conv gradient then differs
    # by percents (seen with seed 4). Seed 3 has no such window.
    seeds = {"unet": 0, "vae": 1, "conditioner": 2, "lpips": 3, "landmark_head": 3}
    params = {name: random_tree(tree, seed=seeds[name]) for name, tree in shapes.items()}
    key = next(jax.random.key(s) for s in range(100)
               if len(set(jax_draws(jax.random.key(s), 2, 8, TrainConfig())["drop"])) == 2)
    return jcfg, params, train_batch(), key


def port_full_step(params, train_cfg=None, **recon_kw):
    """(train_step, loss_fn, state) of the port's tiny full-loss step on the
    CPU, from the port's state dicts."""
    from reface_tpu_torch.pipelines import train as PT
    from reface_tpu_torch.pipelines.swap import tiny_swap_config

    step, loss_fn, init_state = PT.make_train_step(
        tiny_swap_config(image_size=64, ddim_steps=2), train_cfg or PT.TrainConfig(),
        recon=PT.ReconLossConfig(**RECON_KW, **recon_kw), device="cpu")
    return step, loss_fn, init_state(params)


def check_full_loss_matches_jax(setup, want_metrics: set, frozen: set, **recon_kw):
    """make_train_step(..., recon=ReconLossConfig(**RECON_KW, **recon_kw)):
    the total and every metric (`want_metrics`, the same names on both
    sides) within 1e-5 relative and every trainable gradient within 1e-4
    relative L2 of jax.value_and_grad of the JAX loss_fn; the towers in
    `frozen` get no gradient on either side. A gradient is taken relative to
    the larger of the leaf's norm and 1e-3 of the whole gradient's (see
    tests/test_torch_port_train.py::test_eps_step_matches_jax). The
    "landmark_head" tree is passed when recon_kw sets landmark_weight.
    Returns the port's named parameters with their gradients."""
    from reface_tpu.diffusion.losses import ReconLossConfig
    from reface_tpu.pipelines import train as JT
    from reface_tpu_torch.ckpt import from_jax
    from reface_tpu_torch.pipelines import train as PT

    jcfg, params, batch, key = setup
    with_head = recon_kw.get("landmark_weight", 0.0) > 0
    params = {k: v for k, v in params.items() if with_head or k != "landmark_head"}
    _, j_loss_fn, _ = JT.make_train_step(jcfg, JT.TrainConfig(),
                                         recon=ReconLossConfig(**RECON_KW, **recon_kw))
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True))(
        params, batch, key)
    draws = jax_draws(key, 2, 8, JT.TrainConfig())
    step, _, state = port_full_step(from_jax.swap_from_jax(params), **recon_kw)
    loss, metrics = step.loss_and_grads(state.modules, batch, draws)
    assert set(metrics) == set(j_metrics) == want_metrics
    assert abs(loss.item() / float(j_loss) - 1) < 1e-5
    for k, v in j_metrics.items():
        assert abs(metrics[k].item() / float(v) - 1) < 1e-5, k

    named = PT.named_params(state.modules)
    ref = {f"{tower}.{k}": v.numpy() for tower, sd in
           from_jax.swap_from_jax(jax.tree.map(np.asarray, j_grads)).items()
           for k, v in sd.items()}
    labels = PT.trainable_labels(named)
    total = np.sqrt(sum(np.sum(ref[n].astype(np.float64) ** 2)
                        for n in named if labels[n] == "train"))
    unused = 0
    for name, p in named.items():
        if labels[name] == "freeze":
            assert p.grad is None and not p.requires_grad, name
            assert not np.any(ref[name]), name  # JAX's stop_gradient
        elif p.grad is None:
            assert not np.any(ref[name]), name
            unused += 1
        else:
            diff = np.linalg.norm(p.grad.numpy().astype(np.float64) - ref[name])
            assert diff <= 1e-4 * max(np.linalg.norm(ref[name]), 1e-3 * total), name
    assert unused < 0.1 * len(named)
    assert {n.split(".")[0] for n, l in labels.items() if l == "freeze"} == frozen
    return named


# ------------------------------------------ the attention plain versions' inputs

@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def ulp_bf16(x: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of x (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


def smalld_qkv(seed: int, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def bf16_t(a: np.ndarray):
    return torch.from_numpy(a).to(torch.bfloat16)


def library_bwd(seed: int, d: int):
    """(B, H, N, M) = (1, 2, 256, 256), bf16: the inputs of the port's
    backward plain versions, (q, k, v, lse, do, di) as torch tensors of
    (BH, N, D) = (2, 256, d) with the library's own saved o (for di) and lse,
    and the library's (dq, dk, dv) of jax.vjp through flash_attention, as
    fp32 numpy arrays of the same shape."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(1, 2, 256, d)).astype(np.float32) for _ in range(4))
    scale = d**-0.5
    as_j = lambda a: jnp.asarray(a, jnp.bfloat16)
    jq, jk, jv = map(as_j, (q, k, v))
    o, vjp = jax.vjp(lambda a, b, c: j_flash_attention(a, b, c, scale), jq, jk, jv)
    grads = vjp(as_j(do))
    _, lse = j_flash_residuals(jq, jk, jv, scale)

    flat = lambda a: np.array(a, np.float32).reshape(2, 256, d)
    tq, tk, tv, tdo, to = (torch.from_numpy(flat(a)).to(torch.bfloat16)
                           for a in (q, k, v, do, o.astype(jnp.float32)))
    tlse = torch.from_numpy(np.array(lse, np.float32).reshape(2, 256))
    refs = tuple(flat(g.astype(jnp.float32)) for g in grads)
    return (tq, tk, tv, tlse, tdo, port_row_dot(to, tdo)), refs
