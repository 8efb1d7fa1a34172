"""YAML configuration system with dot access, ``include:`` indirection, and
recursive overrides.

Capability parity with the reference config layer
(``reference:src/utils/config_utils.py:6-141``):

- ``DictConfig``: a dict whose values are reachable with attribute access,
  wrapping nested dicts on the fly.
- Any string leaf of the form ``"include:<path.yaml>"`` is replaced by the
  parsed content of that YAML file, recursively.
- ``update_config(base, override)`` deep-merges ``override`` on top of
  ``base`` (either may be a path, a dict, or an argparse Namespace), creating
  missing keys.
- ``config_from_kwargs`` turns ``{"a.b.c": "1"}`` style flat kwargs into a
  nested config with automatic dtype coercion.
"""

from __future__ import annotations

import argparse
import copy
from pathlib import Path
from typing import Any, Mapping

import yaml

_INCLUDE_PREFIX = "include:"


class DictConfig(dict):
    """Dict with attribute-style access; nested dicts are wrapped on read."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:  # AttributeError so hasattr() works
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, DictConfig):
            value = DictConfig(value)
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_dict(self) -> dict:
        return dict(self)

    def to_plain(self) -> dict:
        """Recursively convert to plain dicts (for YAML/JSON dumping)."""

        def conv(v):
            if isinstance(v, dict):
                return {k: conv(u) for k, u in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(u) for u in v]
            return v

        return conv(self)


def _load_yaml(path: str | Path) -> Any:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def _resolve_includes(node: Any) -> Any:
    """Replace every ``"include:<path>"`` string with the parsed file, depth-first."""
    if isinstance(node, str) and node.startswith(_INCLUDE_PREFIX):
        node = _load_yaml(node[len(_INCLUDE_PREFIX):])
    if isinstance(node, dict):
        return {k: _resolve_includes(v) for k, v in node.items()}
    return node


def _deep_merge(base: Any, override: Any) -> Any:
    """Return override merged onto base; dicts merge recursively, leaves replace."""
    if isinstance(override, dict):
        merged = dict(base) if isinstance(base, dict) else {}
        for key, value in override.items():
            merged[key] = _deep_merge(merged.get(key), value)
        return merged
    return override


def _as_tree(config: Any) -> Any:
    """Normalize a config source (path / Namespace / mapping) to a plain tree."""
    if config is None:
        return None
    if isinstance(config, (str, Path)):
        return _load_yaml(config)
    if isinstance(config, argparse.Namespace):
        return {k: v for k, v in vars(config).items() if v is not None}
    if isinstance(config, Mapping):
        return copy.deepcopy(dict(config))
    return config


def update_config(default_config, config=None) -> DictConfig:
    """Merge ``config`` over ``default_config`` with includes resolved.

    Mirrors ``update_config`` in the reference
    (``reference:src/utils/config_utils.py:59-75``); additionally, an
    argparse Namespace contributes its non-None attributes as top-level keys
    (the reference silently dropped Namespace inputs).
    """
    base = _resolve_includes(_as_tree(default_config))
    over = _resolve_includes(_as_tree(config))
    if over is None:
        merged = base
    elif isinstance(base, dict):
        merged = _deep_merge(base, over)
    else:
        # Non-dict base (e.g. Namespace reduced to dict or scalar): override wins.
        merged = _deep_merge(_as_tree(base) or {}, over)
    if not isinstance(merged, dict):
        merged = {}
    return DictConfig(merged)


def convert_to_dtype(value: Any) -> Any:
    """Coerce a CLI string to list/None/bool/int/float, like the reference
    (``reference:src/utils/config_utils.py:96-120``)."""
    if not isinstance(value, str):
        return value
    value = value.strip()
    if value.startswith("[") and value.endswith("]"):
        inner = value[1:-1].strip()
        if not inner:
            return []
        return [convert_to_dtype(v) for v in inner.split(",")]
    lowered = value.lower()
    if lowered in ("null", "none"):
        return None
    if lowered == "true":
        return True
    if lowered == "false":
        return False
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def config_from_kwargs(kwargs: Mapping[str, Any] | None) -> DictConfig:
    """Build a nested config from flat dot-notation kwargs.

    ``{"model.encoder.dim": "64"}`` -> ``{"model": {"encoder": {"dim": 64}}}``.
    Parity with ``reference:src/utils/config_utils.py:123-141``.
    """
    config: dict = {}
    if kwargs:
        for dotted, raw in kwargs.items():
            value = convert_to_dtype(raw)
            node = config
            parts = dotted.split(".")
            for key in parts[:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = value
    return DictConfig(config)


class ParseKwargs(argparse.Action):
    """argparse action collecting ``key=value`` pairs into a dict."""

    def __call__(self, parser, namespace, values, option_string=None):
        out = {}
        for item in values:
            key, _, value = item.partition("=")
            out[key] = value
        setattr(namespace, self.dest, out)
