"""Config tree: JSON/dict config with dotted-path access and CLI overrides.

A copy of ``contrastiveseg_tpu/utils/config.py``, carried because the port
imports nothing of the JAX package; ``tests/test_torch_port_presets.py``
holds it against the original.  Replaces the reference ``Configer``
(upstream lib/utils/tools/configer.py:20-240).  Differences by design:

  * arbitrary-depth dotted paths (``cfg.get("contrast.proj_dim")``) instead of
    the reference's 1-2-level positional keys;
  * overrides are plain ``key=value`` strings parsed with ``ast.literal_eval``
    (the reference's trailing ``key.path value`` pairs, configer.py:58-145);
  * the env-var flag side-channel of the reference (SURVEY.md §5) is folded
    into the same tree under the ``env`` section;
  * the tree is immutable-by-convention: ``updated()`` returns a new Config so
    configs can be hashed/serialized into checkpoints deterministically.
"""

from __future__ import annotations

import ast
import copy
import json
from typing import Any, Iterator, Mapping


_MISSING = object()


def _literal(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


class Config:
    """A nested-dict configuration with dotted-path accessors."""

    def __init__(self, tree: Mapping[str, Any] | None = None):
        self._tree: dict[str, Any] = copy.deepcopy(dict(tree or {}))

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path) as f:
            return cls(json.load(f))

    @classmethod
    def from_args(
        cls,
        config_file: str | None = None,
        overrides: list[str] | None = None,
        base: Mapping[str, Any] | None = None,
    ) -> "Config":
        """Build from an optional JSON file plus ``key.path=value`` overrides."""
        cfg = cls(base or {})
        if config_file:
            with open(config_file) as f:
                cfg = cfg.merged(json.load(f))
        for ov in overrides or []:
            if "=" not in ov:
                raise ValueError(f"override must look like key.path=value: {ov!r}")
            key, _, val = ov.partition("=")
            if key.endswith("+"):  # list-append, mirroring the reference's `key+`
                key = key[:-1]
                cur = cfg.get(key, default=[])
                if not isinstance(cur, list):
                    raise TypeError(f"cannot append to non-list config key {key!r}")
                cfg = cfg.updated(key, cur + [_literal(val)])
            else:
                cfg = cfg.updated(key, _literal(val))
        return cfg

    # -- access ------------------------------------------------------------
    def get(self, *path: str, default: Any = _MISSING) -> Any:
        """``cfg.get("contrast.proj_dim")`` or ``cfg.get("contrast", "proj_dim")``."""
        keys: list[str] = []
        for p in path:
            keys.extend(p.split("."))
        node: Any = self._tree
        for k in keys:
            if isinstance(node, Mapping) and k in node:
                node = node[k]
            else:
                if default is _MISSING:
                    raise KeyError(".".join(keys))
                return default
        return copy.deepcopy(node)

    def exists(self, *path: str) -> bool:
        return self.get(*path, default=_MISSING_SENTINEL) is not _MISSING_SENTINEL

    def __contains__(self, key: str) -> bool:
        return self.exists(key)

    def __getitem__(self, key: str) -> Any:
        return self.get(key)

    def keys(self) -> Iterator[str]:
        return iter(self._tree.keys())

    # -- functional update --------------------------------------------------
    def updated(self, path: str, value: Any) -> "Config":
        keys = path.split(".")
        new = copy.deepcopy(self._tree)
        node = new
        for k in keys[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise TypeError(f"config path {path!r} crosses a non-dict node")
        node[keys[-1]] = copy.deepcopy(value)
        return Config(new)

    def merged(self, other: Mapping[str, Any] | "Config") -> "Config":
        """Deep-merge ``other`` on top of self."""
        if isinstance(other, Config):
            other = other._tree

        def _merge(dst: dict, src: Mapping) -> dict:
            for k, v in src.items():
                if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
                    _merge(dst[k], v)
                else:
                    dst[k] = copy.deepcopy(v)
            return dst

        return Config(_merge(copy.deepcopy(self._tree), other))

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return copy.deepcopy(self._tree)

    def to_json(self) -> str:
        return json.dumps(self._tree, indent=2, sort_keys=True)

    def __repr__(self) -> str:
        return f"Config({json.dumps(self._tree, sort_keys=True)[:200]}...)"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Config) and self._tree == other._tree


_MISSING_SENTINEL = object()
