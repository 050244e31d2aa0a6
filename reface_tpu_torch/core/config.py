"""Layered YAML + dotlist-override config system (port of
reface_tpu/core/config.py, kept as the port's own copy).

The reference's OmegaConf stack (main.py:504-506): N base YAMLs merged left
to right, then CLI dotlist overrides (`a.b.c=value`, values parsed as
Python literals), without the OmegaConf dependency. Typed dataclass configs
are built from the merged dict with `build`. YAML is read by PyYAML's
safe_load.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, Mapping, Sequence

import yaml

__all__ = ["load_yaml", "merge", "apply_dotlist", "load_config", "build"]


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def merge(*dicts: Mapping) -> dict:
    """Deep merge, right wins (OmegaConf.merge semantics for plain dicts)."""
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            if (
                k in out
                and isinstance(out[k], Mapping)
                and isinstance(v, Mapping)
            ):
                out[k] = merge(out[k], v)
            else:
                out[k] = v
    return out


def _parse_value(s: str) -> Any:
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def apply_dotlist(cfg: dict, overrides: Sequence[str]) -> dict:
    """Apply `a.b.c=value` overrides (values parsed as python literals)."""
    out = merge(cfg)  # deep copy via merge
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, val = item.split("=", 1)
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(val)
    return out


def load_config(bases: Sequence[str], overrides: Sequence[str] = ()) -> dict:
    return apply_dotlist(merge(*(load_yaml(b) for b in bases)), overrides)


def build(cls, cfg: Mapping, **extra):
    """Construct a dataclass from a config mapping, recursing into nested
    dataclass fields; unknown keys raise."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = dict(extra)
    for k, v in cfg.items():
        if k not in fields:
            raise KeyError(f"{cls.__name__} has no field {k!r}")
        ftype = fields[k].type
        default = fields[k].default
        if isinstance(v, Mapping) and dataclasses.is_dataclass(default):
            kwargs[k] = build(type(default), v)
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)
