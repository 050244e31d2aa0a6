"""The port's layered config (reface_tpu_torch/core/config.py) and its
SwapConfig front end (reface_tpu_torch/cli/common.py::resolve_swap_config)
against the JAX package's, on the same YAML files and dotlists.

resolve_swap_config is held field by field, every nested field included,
for each flag set of tests/test_cli_config.py and a few more; dtypes are
compared by name (jnp.bfloat16 against torch.bfloat16).
"""

import argparse
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import one_torch_thread

from reface_tpu.cli import common as JCLI
from reface_tpu.core import config as JC
from reface_tpu_torch.cli import common as PCLI
from reface_tpu_torch.core import config as PC

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

_YAML = """\
# a commented, sectioned config
swap:
  ddim_steps: 30     # trailing comment
  cfg_scale: 2.5
  unet:
    channel_mult: [1, 2, 4]
    attention_resolutions:
      - 4
      - 2
    use_checkpoint: false
train:
  learning_rate: 2.0e-5
  name: "run a"
  tags: [x, 'y z']
  nothing: null
"""


@dataclasses.dataclass(frozen=True)
class _Inner:
    a: int = 1
    b: tuple = (1,)


@dataclasses.dataclass(frozen=True)
class _Outer:
    inner: _Inner = _Inner()
    lr: float = 1e-4
    name: str = ""


def test_config_module_matches_jax(tmp_path):
    """load_yaml, merge, apply_dotlist, load_config and build give the JAX
    module's results."""
    base, over, empty = tmp_path / "base.yaml", tmp_path / "over.yaml", tmp_path / "e.yaml"
    base.write_text(_YAML)
    over.write_text("swap:\n  cfg_scale: 4.0\n  unet: {model_channels: 64}\n")
    empty.write_text("# nothing\n")
    for path in (base, over, empty):
        assert PC.load_yaml(str(path)) == JC.load_yaml(str(path))
    dots = ["swap.cfg_scale=5.0", "swap.unet.num_heads=4", "train.tags=['a', 'b']",
            "new.deep.key=hello", "swap.flag=True"]
    assert PC.load_config([str(base), str(over), str(empty)], dots) == \
        JC.load_config([str(base), str(over), str(empty)], dots)
    a, b = {"x": {"y": 1, "z": [1]}, "k": 2}, {"x": {"y": 3}, "k": {"n": 1}}
    assert PC.merge(a, b) == JC.merge(a, b)
    assert PC.apply_dotlist(a, ["x.w=(1, 2)"]) == JC.apply_dotlist(a, ["x.w=(1, 2)"])
    with pytest.raises(ValueError, match="not key=value"):
        PC.apply_dotlist({}, ["novalue"])
    node = {"inner": {"a": 3, "b": [4, 5]}, "lr": 0.5, "name": "n"}
    assert PC.build(_Outer, node) == JC.build(_Outer, node)
    with pytest.raises(KeyError, match="no field 'zz'"):
        PC.build(_Outer, {"zz": 1})


def _fields(cfg, prefix=""):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{prefix}{f.name}."))
        elif isinstance(v, torch.dtype):
            out[prefix + f.name] = str(v).removeprefix("torch.")
        elif f.name.endswith("dtype") and v is not None:
            out[prefix + f.name] = jnp.dtype(v).name
        else:
            out[prefix + f.name] = v
    return out


def _parse(add, argv):
    ap = argparse.ArgumentParser()
    add(ap)
    return ap.parse_args(argv)


def _flag_sets(tmp_path):
    y1, y2, bare = (tmp_path / n for n in ("base.yaml", "over.yaml", "bare.yaml"))
    y1.write_text("swap:\n  ddim_steps: 30\n  cfg_scale: 2.5\n")
    y2.write_text("swap:\n  cfg_scale: 4.0\n")
    bare.write_text("ddim_steps: 30\ntrain:\n  learning_rate: 2.0e-5\n")
    y1, y2, bare = map(str, (y1, y2, bare))
    return [  # tests/test_cli_config.py's, then more
        ["--config", y1], ["--config", y1, y2],
        ["--config", y1, "--overrides", "swap.cfg_scale=5.0"],
        ["--config", y1, "--ddim-steps", "25"],
        ["--overrides", "swap.unet.model_channels=64", "swap.vae_tile=4"],
        ["--config", bare], ["--config", bare, "--overrides", "swap.cfg_scale=5.0"],
        ["--tiny", "--overrides", "swap.unet.model_channels=8"],
        ["--tiny", "--ddim-steps", "8"], ["--tiny", "--attn", "einsum"],
        ["--sampler", "dpm"], ["--sampler", "dpm", "--discretize", "uniform"], [],
        ["--overrides", "sampler=dpm"],
        ["--quant", "int8conv", "--quant-cond", "--cfg-steps", "8", "--scale", "2.0"],
        ["--tiny", "--sampler", "plms", "--attn", "fast", "--quant", "int8"],
        ["--overrides", "swap.unet.dtype=float32", "swap.unet.channel_mult=[1,2]",
         "swap.unet.fused_groupnorm=True"],
        ["--config", bare, "--overrides", "ddim_discretize=uniform", "--sampler", "dpm"],
    ]


def test_resolve_swap_config_matches_jax(tmp_path):
    for argv in _flag_sets(tmp_path):
        want = JCLI.resolve_swap_config(_parse(JCLI.add_model_args, argv))
        got = PCLI.resolve_swap_config(_parse(PCLI.add_model_args, argv))
        assert _fields(got) == _fields(want), argv


def test_model_flags_keep_the_jax_names_and_defaults():
    """Every flag of the JAX add_model_args has the same default in the
    port's, except --backend, which is --device (cuda unless asked)."""
    want = vars(_parse(JCLI.add_model_args, []))
    got = vars(_parse(PCLI.add_model_args, []))
    assert want.pop("backend") is None and got.pop("device") == "cuda"
    assert want == got


def test_apply_config_node_and_masks():
    from reface_tpu_torch.pipelines.swap import SwapConfig

    cfg = PCLI.apply_config_node(SwapConfig(), {"unet": {"channel_mult": [1, 2],
                                                         "dtype": "float32"}})
    assert cfg.unet.channel_mult == (1, 2) and cfg.unet.dtype == torch.float32
    assert cfg.unet.model_channels == SwapConfig().unet.model_channels
    np.testing.assert_array_equal(PCLI.default_inpaint_mask(64), JCLI.default_inpaint_mask(64))
