"""Config resolver with reference-dialect parity.

The reference drives all model construction from JSON configs written in the
MONAI bundle dialect (see reference ``3d_ldm/utils.py:243-246`` and
``3d_ldm/config/config_train_32g.json``):

  * ``"@key"``      — a reference to another (resolved) config entry,
  * ``"$expr"``     — a Python expression; ``@key`` tokens inside are
                      substituted with their resolved values before eval,
  * ``{"_target_": "pkg.Class", ...}`` — instantiate a class with the
                      remaining (resolved) entries as keyword arguments.

This module is the port's own copy of ``ldm3d_tpu/configs/resolver.py``.
Class paths are looked up in :mod:`ldm3d_torch.configs.registry`, which maps
the JAX package's class names and the torch/MONAI names used by the
reference configs onto the port's ``nn.Module`` constructors, so the same
config files work unchanged.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Mapping

__all__ = ["ConfigResolver", "define_instance", "load_json"]

_REF_RE = re.compile(r"@([A-Za-z_][A-Za-z0-9_]*(?:::[A-Za-z0-9_]+)*)")


class ConfigResolutionError(Exception):
    pass


class ConfigResolver:
    """Resolves ``@ref`` / ``$expr`` / ``_target_`` entries of a config tree.

    Resolution is lazy and memoized per top-level id, mirroring
    ``ConfigParser.get_parsed_content`` in the reference stack. Nested ids are
    addressed with ``::`` (e.g. ``autoencoder_def::channels``).
    """

    def __init__(self, config: Mapping[str, Any], registry: Mapping[str, Callable] | None = None):
        if registry is None:
            from ldm3d_torch.configs.registry import default_registry

            registry = default_registry()
        self._config = dict(config)
        self._registry = dict(registry)
        self._cache: dict[str, Any] = {}
        self._resolving: set[str] = set()

    # -- public API ---------------------------------------------------------

    def resolve(self, key: str) -> Any:
        """Resolve the entry at ``key`` (``::``-separated path) fully."""
        if key in self._cache:
            return self._cache[key]
        if key in self._resolving:
            raise ConfigResolutionError(f"circular reference involving {key!r}")
        self._resolving.add(key)
        try:
            raw = self._lookup_raw(key)
            value = self._resolve_node(raw)
        finally:
            self._resolving.discard(key)
        self._cache[key] = value
        return value

    def instantiate(self, key: str) -> Any:
        """Resolve ``key`` and, if it is a ``_target_`` dict, build the object."""
        return self.resolve(key)

    def keys(self):
        return self._config.keys()

    # -- internals ----------------------------------------------------------

    def _lookup_raw(self, key: str) -> Any:
        node: Any = self._config
        for part in key.split("::"):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            elif isinstance(node, (list, tuple)) and part.isdigit():
                node = node[int(part)]
            else:
                raise ConfigResolutionError(f"config key not found: {key!r} (missing {part!r})")
        return node

    def _resolve_node(self, node: Any) -> Any:
        if isinstance(node, str):
            return self._resolve_string(node)
        if isinstance(node, Mapping):
            if "_target_" in node:
                return self._instantiate_target(node)
            return {k: self._resolve_node(v) for k, v in node.items()}
        if isinstance(node, list):
            return [self._resolve_node(v) for v in node]
        if isinstance(node, tuple):
            return tuple(self._resolve_node(v) for v in node)
        return node

    def _resolve_string(self, s: str) -> Any:
        if s.startswith("$"):
            return self._eval_expr(s[1:])
        if s.startswith("@"):
            return self.resolve(s[1:])
        return s

    def _eval_expr(self, expr: str) -> Any:
        refs: dict[str, Any] = {}

        def _sub(m: re.Match) -> str:
            ref_key = m.group(1)
            var = "__ref_%d" % len(refs)
            refs[var] = self.resolve(ref_key)
            return var

        py_expr = _REF_RE.sub(_sub, expr)
        namespace: dict[str, Any] = {"__builtins__": {}}
        # A small, safe-ish eval surface: math helpers only. The reference
        # dialect allows arbitrary python; we expose the same power minus
        # builtins that touch the filesystem.
        import math

        namespace.update({"math": math, "min": min, "max": max, "len": len, "int": int, "float": float})
        namespace.update(refs)
        try:
            return eval(py_expr, namespace)  # noqa: S307 - dialect parity
        except Exception as e:  # pragma: no cover - error path
            raise ConfigResolutionError(f"failed to evaluate expression {expr!r}: {e}") from e

    def _instantiate_target(self, node: Mapping[str, Any]) -> Any:
        target = node["_target_"]
        if target not in self._registry:
            raise ConfigResolutionError(
                f"unknown _target_ {target!r}; known: {sorted(self._registry)}"
            )
        kwargs = {k: self._resolve_node(v) for k, v in node.items() if k != "_target_"}
        disabled = kwargs.pop("_disabled_", False)
        if disabled:
            return None
        return self._registry[target](**kwargs)


def define_instance(args: Any, instance_def_key: str) -> Any:
    """Reference-parity helper (``3d_ldm/utils.py:243-246``): build the object
    described by ``args.<instance_def_key>`` with references resolved against
    the full ``args`` namespace."""
    namespace = vars(args) if not isinstance(args, Mapping) else dict(args)
    return ConfigResolver(namespace).instantiate(instance_def_key)


def load_json(path: str) -> dict[str, Any]:
    with open(path, "r") as f:
        return json.load(f)
