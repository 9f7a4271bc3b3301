"""Nested config tree: attribute access, dotted paths, ``${ENV}``
interpolation and ``_target_`` instantiation.

Port of ``automodel_tpu/config/loader.py``. ``ConfigNode.instantiate``
keeps JAX's semantics (:207-236): sibling keys become kwargs, nested
``_target_`` nodes are built first unless listed in ``_no_instantiate_``,
and a target must lie under an allowlisted prefix. A target under
``automodel_tpu.`` resolves to the same path under ``automodel_tpu_torch.``,
the port's twin, and is never imported from the JAX package, so the
committed YAML recipes name their objects unchanged. A target under
``jax``, ``optax``, ``flax`` or ``orbax`` is refused by name, and so is a
twin the port does not have yet, naming its first missing module.
PyYAML is imported only where YAML is read, so a config built as a plain
dict works on a machine without it.
"""

from __future__ import annotations

import importlib
import os
import re
from typing import Any, Iterator, Mapping

_ENV_RE = re.compile(r"\$\{(?:env:)?([A-Za-z_][A-Za-z0-9_]*)(?::([^}]*))?\}")
_SCI_NOTATION_RE = re.compile(r"^[+-]?\d+(\.\d*)?[eE][+-]?\d+$")
_INT_RE = re.compile(r"^[+-]?\d+$")
_FLOAT_RE = re.compile(r"^[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?$")

# dotted-path prefixes a ``_target_`` may import (JAX :28-41, without the
# JAX stack, which the port refuses by name)
_IMPORT_ALLOWLIST_PREFIXES = (
    "automodel_tpu_torch",
    "automodel_tpu",
    "numpy",
    "builtins",
    "torch",
    "transformers",
    "datasets",
    "math",
    "functools",
)
_JAX_STACK_PREFIXES = ("jax", "optax", "flax", "orbax")
_JAX_PACKAGE = "automodel_tpu"
_PORT_PACKAGE = "automodel_tpu_torch"


def _under(path: str, prefix: str) -> bool:
    return path == prefix or path.startswith(prefix + ".")


def port_target(path: str) -> str:
    """A ``_target_`` of the JAX package → the same path in the port."""
    if _under(path, _JAX_PACKAGE):
        return _PORT_PACKAGE + path[len(_JAX_PACKAGE):]
    return path


def resolve_target(path: str) -> Any:
    """Resolve a dotted ``_target_`` path ``pkg.mod.attr`` to the attribute:
    the longest importable module prefix, then ``getattr`` for the rest."""
    for prefix in _JAX_STACK_PREFIXES:
        if _under(path, prefix):
            raise ValueError(f"_target_ {path!r} names {prefix}, which the torch backend does not run")
    if not any(_under(path, p) for p in _IMPORT_ALLOWLIST_PREFIXES):
        raise ValueError(f"_target_ {path!r} is outside the import allowlist {_IMPORT_ALLOWLIST_PREFIXES}")
    target = port_target(path)
    parts = target.split(".")
    for i in range(len(parts), 0, -1):
        mod_path = ".".join(parts[:i])
        try:
            obj = importlib.import_module(mod_path)
        except ModuleNotFoundError as e:
            # only "this prefix is not a module" moves on; an ImportError
            # raised while executing the module is a real failure
            if e.name is not None and (
                mod_path == e.name or mod_path.startswith(e.name + ".") or e.name.startswith(mod_path + ".")
            ):
                continue
            raise
        for j in range(i, len(parts)):
            if not hasattr(obj, parts[j]):
                missing = ".".join(parts[: j + 1])
                if _under(target, _PORT_PACKAGE):
                    kind = "module" if j == i and j < len(parts) - 1 else "name"
                    raise ValueError(
                        f"_target_ {path!r} resolves to {target!r}, which the torch backend does not have "
                        f"yet (first missing {kind}: {missing})"
                    )
                raise ValueError(f"_target_ {path!r}: {missing} does not exist")
            obj = getattr(obj, parts[j])
        return obj
    raise ImportError(f"Could not resolve _target_ {path!r}")


def _interp_env(value: str) -> str:
    """Expand ``${VAR}`` / ``${env:VAR}`` / ``${VAR:default}`` in a string."""

    def sub(m: re.Match) -> str:
        name, default = m.group(1), m.group(2)
        if name in os.environ:
            return os.environ[name]
        if default is not None:
            return default
        raise KeyError(f"Environment variable {name!r} referenced in config is not set")

    return _ENV_RE.sub(sub, value)


def _scalar(v: str) -> Any:
    """YAML's scalar rules for the cases a CLI override uses, for a machine
    without PyYAML: null, booleans, ints, floats, else the string."""
    s = v.strip()
    low = s.lower()
    if low in ("null", "~", "none", ""):
        return None
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if _INT_RE.match(s):
        return int(s)
    if _FLOAT_RE.match(s):
        return float(s)
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    return v


def translate_value(v: str) -> Any:
    """Parse a CLI override string into a Python value (YAML semantics)."""
    try:
        import yaml
    except ImportError:
        return _scalar(v)
    try:
        out = yaml.safe_load(v)
    except yaml.YAMLError:
        return v
    if isinstance(out, str) and out == v and _SCI_NOTATION_RE.match(out):
        # YAML 1.1 parses dotless scientific notation ('1e-2') as a string
        return float(out)
    return out


class ConfigNode(Mapping):
    """A nested attribute-accessible config tree.

    ``node.key`` and ``node["key"]`` both work; ``get("a.b.c", default)``
    walks dotted paths; ``set_by_path`` is the CLI override hook."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        for k, v in (data or {}).items():
            self._data[k] = self._wrap(v)

    @staticmethod
    def _wrap(v: Any) -> Any:
        if isinstance(v, ConfigNode):
            return v
        if isinstance(v, dict):
            return ConfigNode(v)
        if isinstance(v, (list, tuple)):
            return [ConfigNode._wrap(x) for x in v]
        if isinstance(v, str) and "${" in v:
            whole = _ENV_RE.fullmatch(v) is not None
            expanded = _interp_env(v)
            if whole and expanded != v:
                # type-coerce only a value that was one whole interpolation
                parsed = translate_value(expanded)
                return parsed if not isinstance(parsed, (dict, list)) else expanded
            return expanded
        return v

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(f"Config has no key {key!r}; keys: {list(self._data)}")

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = self._wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = self._wrap(value)

    def get(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, ConfigNode) and part in node._data:
                node = node._data[part]
            else:
                return default
        return node

    def set_by_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node._data or not isinstance(node._data[part], ConfigNode):
                node._data[part] = ConfigNode()
            node = node._data[part]
        node._data[parts[-1]] = self._wrap(value)

    def delete_by_path(self, path: str) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            node = node._data[part]
        del node._data[parts[-1]]

    def to_dict(self) -> dict:
        def unwrap(v: Any) -> Any:
            if isinstance(v, ConfigNode):
                return v.to_dict()
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return {k: unwrap(v) for k, v in self._data.items()}

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"

    def instantiate(self, *args: Any, **overrides: Any) -> Any:
        """Build the object this node's ``_target_`` names: sibling keys
        become kwargs, nested nodes with their own ``_target_`` are built
        first unless the key is in ``_no_instantiate_``, and ``overrides``
        win over config keys."""
        if "_target_" not in self._data:
            raise ValueError(f"Node has no _target_: {self!r}")
        target = self._data["_target_"]
        fn = resolve_target(target) if isinstance(target, str) else target
        no_inst = set(self._data.get("_no_instantiate_", []) or [])

        def build(v: Any) -> Any:
            if isinstance(v, ConfigNode) and "_target_" in v:
                return v.instantiate()
            if isinstance(v, list):
                return [build(x) for x in v]
            return v

        kwargs = {
            k: v if k in no_inst else build(v)
            for k, v in self._data.items() if k not in ("_target_", "_no_instantiate_")
        }
        kwargs.update(overrides)
        return fn(*args, **kwargs)


def load_yaml_config(path: str | os.PathLike) -> ConfigNode:
    """A YAML config file → ConfigNode. A ``.json`` file (JSON is YAML) is
    read with ``json``, so a config written by a program loads where
    PyYAML is not installed."""
    if str(path).endswith(".json"):
        import json

        with open(path) as f:
            return ConfigNode(json.load(f) or {})
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return ConfigNode(raw)
