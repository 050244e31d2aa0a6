"""The port's data x tensor-parallel step against the JAX package's mesh step,
on the CPU.

- Four gloo ranks (tests/torch_port_parallel_ranks.py) run the port's step
  on a 2 x 2 (data, model) mesh against jax.value_and_grad of the JAX
  loss_fn under create_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
  with shard_params_tp and shard_batch, fed the JAX key's draws (jax_draws):
  the loss within 1e-5 relative and every trainable gradient (the UNet's
  gathered) within 1e-4 relative L2 of the larger of its norm and 1e-3 of
  the whole gradient's (tests/test_torch_port_train.py's eps-step limits).
  The UNet is test_torch_port_parallel.py's small config, where a conv, a
  self-attention and a GEGLU shard on both sides. The JAX program is
  compiled at XLA's backend optimisation level 0 (the same function, its
  CPU code less optimised: a third less compile time).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_port_parallel_ranks as R
from torch_port_parallel_ranks import SMALL
from test_torch_port_helpers import PORT_NICE, jax_draws, one_torch_thread, random_tree
from test_torch_port_helpers import train_batch

from reface_tpu.parallel import create_mesh as j_create_mesh
from reface_tpu.parallel import shard_batch as j_shard_batch
from reface_tpu.parallel.tp import shard_params_tp as j_shard_params_tp
from reface_tpu.pipelines import train as JT
from reface_tpu.pipelines.swap import FaceSwapper as JSwapper
from reface_tpu.pipelines.swap import tiny_swap_config as j_tiny
from reface_tpu_torch.ckpt import from_jax
from reface_tpu_torch.pipelines import train as PT

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def test_dp_tp_step_matches_jax_mesh(tmp_path):
    jcfg = j_tiny(image_size=64)
    jcfg = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, **SMALL))
    shapes = jax.eval_shape(lambda k: JSwapper.init_params(jcfg, k), jax.random.key(0))
    params = {name: random_tree(tree, seed=i) for i, (name, tree) in enumerate(shapes.items())}
    tcfg = JT.TrainConfig()
    key = next(jax.random.key(s) for s in range(100)
               if len(set(jax_draws(jax.random.key(s), 4, 8, tcfg)["drop"])) == 2)
    batch = train_batch(b=4)
    torch.save({"params": from_jax.swap_from_jax(params), "batch": batch,
                "draws": jax_draws(key, 4, 8, tcfg)}, tmp_path / "inputs.pt")
    R.spawn(4, tmp_path, PORT_NICE, meshes=[("dp_tp", 2, 2)], cfg_kw=SMALL)
    got = torch.load(tmp_path / "dp_tp.pt", weights_only=False)
    assert got["sharded"] == {"conv": True, "self_attention": True, "geglu": True}

    mesh = j_create_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    _, j_loss_fn, _ = JT.make_train_step(jcfg, tcfg)
    args = (j_shard_params_tp(params, mesh), j_shard_batch(batch, mesh), key)
    with mesh:
        step = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True)).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})
        (j_loss, _), j_grads = step(*args)
    assert abs(got["loss"] / float(j_loss) - 1) < 1e-5

    ref = {f"{tower}.{k}": v.numpy() for tower, sd in
           from_jax.swap_from_jax(jax.tree.map(np.asarray, j_grads)).items()
           for k, v in sd.items() if tower in ("unet", "conditioner")}
    assert set(got["grads"]) <= set(ref)  # ref also holds the BatchNorm buffers
    labels = PT.trainable_labels(ref)
    total = np.sqrt(sum(np.sum(ref[n].astype(np.float64) ** 2)
                        for n in ref if labels[n] == "train"))
    compared = 0
    for name, g in got["grads"].items():
        if labels[name] == "freeze" or g is None:
            assert not np.any(ref[name]), name  # stop_gradient / an unused leaf
            continue
        diff = np.linalg.norm(g.numpy().astype(np.float64) - ref[name])
        assert diff <= 1e-4 * max(np.linalg.norm(ref[name]), 1e-3 * total), name
        compared += 1
    assert compared > 100
