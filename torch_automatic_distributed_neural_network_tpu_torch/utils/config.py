"""Config / flag system: one dataclass tree with ``key=value`` CLI
overrides, serializable into checkpoints for reproducibility (the JAX
package's ``utils/config.py``, copied: it is framework-free).

Override syntax: dotted paths into the tree, values parsed as Python
literals when possible (``model.d_model=1024 run.steps=500
parallel.strategy=tp_fsdp``).
"""

from __future__ import annotations

import ast
import dataclasses
import json
from typing import Any, Sequence


def to_dict(cfg: Any) -> dict:
    if dataclasses.is_dataclass(cfg):
        return {
            f.name: to_dict(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)
        }
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, type):
        return cfg.__name__
    return cfg


def to_json(cfg: Any) -> str:
    return json.dumps(to_dict(cfg), indent=2, default=str)


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text  # bare strings


def apply_overrides(cfg: Any, overrides: Sequence[str]) -> Any:
    """Return a copy of the dataclass tree with ``a.b.c=value`` overrides
    applied.  Unknown keys raise with the list of valid keys at that level."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override {item!r} is not key=value")
        key, _, raw = item.partition("=")
        cfg = _set_path(cfg, key.strip().split("."), _parse_value(raw.strip()))
    return cfg


def _set_path(cfg: Any, path: list[str], value: Any) -> Any:
    head, rest = path[0], path[1:]
    if dataclasses.is_dataclass(cfg):
        names = [f.name for f in dataclasses.fields(cfg)]
        if head not in names:
            raise KeyError(
                f"No config field {head!r}; valid fields: {sorted(names)}"
            )
        cur = getattr(cfg, head)
        new = _set_path(cur, rest, value) if rest else value
        return dataclasses.replace(cfg, **{head: new})
    if isinstance(cfg, dict):
        if rest:
            new = _set_path(cfg[head], rest, value)
        else:
            new = value
        out = dict(cfg)
        out[head] = new
        return out
    raise KeyError(f"Cannot descend into {type(cfg).__name__} at {head!r}")
