"""The data-parallel full-loss step (split_grad 1 and 2 with the bf16
accumulator, reface_tpu_torch/pipelines/train.py) on the CPU.

Two gloo ranks spawned on a file store (tests/torch_port_parallel_ranks.py)
run one step of the tiny full-loss config of test_torch_port_split_acc.py
(the ID term alone) at each level, batch 2 a rank, against the one-process
step on the same global batch of 4, the same params and the same draws (a
dropped and a kept sample). The learning rate moves the weights well above
their rounding and the clip engages (STEP_TCFG). The recon chain's
references are the global batch flipped (ReconLossConfig.flip_reference),
which a rank's rows take from the mirror rank: with each rank flipping its
own rows instead, the loss moves by 1.4e-2.

The JAX step rounds the global batch's recon gradient to bf16 once. The
ranks differ from it only where they round:

- split_grad 1 averages the ranks' fp32 recon gradients and rounds that
  mean once. It differs from the one-process fp32 gradient by summation
  order alone (rel 1e-7), so the two roundings differ by one bf16 ulp
  (2^-8 of the value) only at the few elements whose fp32 value lies within
  that distance of a rounding midpoint.
- split_grad 2 carries each rank's pullback in bf16 over its own rows, as
  the JAX step carries the global batch's, then averages the two bf16 sums
  and rounds the mean once more. Each bf16 contribution's rounding error is
  up to 2^-9 of its value; summed over half the rows each, the rank's sums
  round differently from the whole batch's, so the recon gradient may move
  by about that rounding, never by more than a few ulps.

Tolerances: the loss and every metric within 1e-6 relative (fp32 forward,
only the batch's summation order moves; seen 0 and 7e-8); the clip's global
norm within 1e-5 relative (seen 2e-7). The gradient, relative L2 over all
trainable tensors, within GRAD_TOL of the level:

- level 1, 3e-5 (seen 7.3e-6): only the few elements whose fp32 recon
  gradient lies within summation-order noise of a bf16 rounding midpoint
  round the other way, by one ulp. Each rank rounding its own recon
  gradient before the average reads 1.2e-4, and fails it.
- level 2, 2e-3 (seen 2.0e-4): one bf16 half-ulp (2^-9) of the whole
  gradient, the most that one moved rounding point of the recon portion may
  shift an element by; the fp32 accumulator sits 2e-2 away
  (test_torch_port_split_acc.py).

The updated parameters, relative L2 per tower, within PARAM_TOL: level 1,
1e-5 (seen 4.7e-7); level 2, 1e-4 (seen 2.3e-5). Adam's first step moves an
element by +-lr wherever its clipped gradient is well above eps, so only
elements whose gradient lies within the level's rounding of zero can move
the other way, by 2 lr each.
"""

import pytest
import torch

import torch_port_parallel_ranks as R
from test_torch_port_helpers import PORT_NICE, one_torch_thread, train_batch

from reface_tpu_torch.pipelines import train as PT
from reface_tpu_torch.pipelines.swap import init_params

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

# relative L2, per split_grad level (see above): over all trainable
# gradients, and over each trained tower's updated parameters
GRAD_TOL = {1: 3e-5, 2: 2e-3}
PARAM_TOL = {1: 1e-5, 2: 1e-4}


@pytest.fixture(scope="module")
def split_steps(tmp_path_factory):
    """The one-process full-loss step and the two ranks' at each level, from
    one set of params (seeded, zero-initialised layers re-randomised), one
    batch of 4 and one set of draws."""
    tmp = tmp_path_factory.mktemp("parallel_split")
    modules = PT.TrainModules(R.step_config(None, split_grad=1), "cpu")
    for i, m in enumerate(modules.towers().values()):
        init_params(m, seed=i, dezero=True)
    params = {n: m.state_dict() for n, m in modules.towers().items()}
    batch = train_batch(b=4)
    draws = {k: v.numpy() for k, v in PT.make_draws(
        4, 8, PT.TrainConfig(), "cpu", torch.Generator().manual_seed(5)).items()}
    draws["drop"][:2] = [True, False]
    torch.save({"params": params, "batch": batch, "draws": draws}, tmp / "inputs.pt")
    refs = {level: R.one_step(None, None, params, batch, draws, split_grad=level)
            for level in (1, 2)}
    R.spawn(2, tmp, PORT_NICE, split_grads=(1, 2))
    return refs, {level: torch.load(tmp / f"split{level}.pt", weights_only=False)
                  for level in (1, 2)}


def _rel_all(got: dict, ref: dict) -> float:
    """Relative L2 over every tensor of `ref` together."""
    num = sum(float((got[k].double() - v.double()).pow(2).sum()) for k, v in ref.items())
    return (num / sum(float(v.double().pow(2).sum()) for v in ref.values())) ** 0.5


@pytest.mark.parametrize("level", [1, 2])
def test_dp_split_step_matches_one_process(split_steps, level):
    refs, gots = split_steps
    ref, got = refs[level], gots[level]
    assert abs(got["loss"] / ref["loss"] - 1) < 1e-6
    assert got["metrics"].keys() == ref["metrics"].keys()
    assert "id_loss" in ref["metrics"]  # the recon portion ran
    for k, v in ref["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-6 * abs(v), k
    assert ref["grad_norm"] > R.STEP_TCFG["grad_clip"]  # the clip engages
    assert abs(got["grad_norm"] / ref["grad_norm"] - 1) < 1e-5
    grads = {k: g for k, g in ref["grads"].items() if g is not None}
    assert {k for k, g in got["grads"].items() if g is not None} == set(grads)
    assert any(k.startswith("conditioner.") for k in grads) and len(grads) > 100
    rel = _rel_all(got["grads"], grads)
    assert rel <= GRAD_TOL[level], rel
    assert got["params"].keys() == ref["params"].keys()
    for tower in ("unet.", "conditioner."):
        part = {k: v for k, v in ref["params"].items() if k.startswith(tower)}
        assert _rel_all(got["params"], part) <= PARAM_TOL[level], tower
