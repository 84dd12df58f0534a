"""Typed-ish config tree (a copy of ``ipoke_tpu/core/config.py``, which
the port may not import).

The reference drives everything from nested YAML dicts with sections
``general / data / architecture / training / logging / testing`` plus per-stage
blocks (``first_stage``, ``conditioner``, ``poke_embedder``, ...) — see
reference ``config/second_stage.yaml`` and ``main.py:18-63``.  We keep the same
section names and string keys so shipped YAML configs remain loadable, but wrap
them in an attribute-access view with explicit defaulting instead of the
reference's pervasive ``'k' in config and config['k']`` pattern.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Mapping

import yaml


class Config(dict):
    """Nested dict with attribute access and recursive wrapping."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kw):
        super().__init__()
        merged = dict(data or {})
        merged.update(kw)
        for k, v in merged.items():
            self[k] = _wrap(v)

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover - attribute protocol
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    # -- helpers -----------------------------------------------------------
    def get_path(self, path: str, default: Any = None) -> Any:
        """``cfg.get_path('architecture.z_dim', 32)``"""
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def merged_with(self, other: Mapping[str, Any]) -> "Config":
        out = copy.deepcopy(self)
        _deep_update(out, other)
        return out

    def to_dict(self) -> dict:
        return json.loads(json.dumps(self, default=_jsonable))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def _jsonable(v):
    if isinstance(v, tuple):
        return list(v)
    return str(v)


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _deep_update(base: dict, other: Mapping[str, Any]) -> None:
    for k, v in other.items():
        if isinstance(v, Mapping) and isinstance(base.get(k), Mapping):
            _deep_update(base[k], v)
        else:
            base[k] = _wrap(v)


class _PermissiveLoader(yaml.SafeLoader):
    """SafeLoader that also understands the reference's `!!python/tuple` tags
    (reference configs use `!!python/tuple [128,128]`, e.g.
    `config/first_stage.yaml:15`)."""


def _tuple_constructor(loader, node):
    return tuple(loader.construct_sequence(node))


_PermissiveLoader.add_constructor(
    "tag:yaml.org,2002:python/tuple", _tuple_constructor
)


def load_config(path: str, overrides: Mapping[str, Any] | None = None) -> Config:
    with open(path) as f:
        raw = yaml.load(f, Loader=_PermissiveLoader)
    cfg = Config(raw or {})
    if overrides:
        cfg = cfg.merged_with(overrides)
    return cfg
