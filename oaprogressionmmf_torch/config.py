"""Configuration: a YAML tree with dotted command-line overrides.

Port of ``oaprogressionmmf_tpu/config.py``, the subset of Hydra and
OmegaConf the apps use:

  * a root YAML config and a ``model=<name>`` config group that puts the
    selected ``conf/model/<name>.yaml`` under the ``model`` key,
  * dotted-key overrides (``a.b.c=value``) and ``+a.b=value`` additions,
  * values parsed as YAML (lists, bools, numbers, null),
  * ``${key.path}`` and ``${now:%fmt}`` interpolation, resolved lazily,
  * the mandatory-value marker ``???``.

Access is attribute- or item-style, as OmegaConf's. PyYAML is imported
inside :func:`load_config` and :meth:`Config.to_yaml` only: the rest runs
without it (the apps' ``run(config)`` takes a tree built in Python).
"""

from __future__ import annotations

import copy
import datetime
import re
from pathlib import Path
from typing import Any, Iterator, Mapping


_INTERP_RE = re.compile(r"\$\{([^}]+)\}")
MISSING = "???"


class MissingMandatoryValue(RuntimeError):
    pass


class Config(Mapping):
    """Nested attribute/item-access view over a dict tree with interpolation."""

    def __init__(self, data: dict | None = None, root: "Config | None" = None):
        # hold the dict by REFERENCE: nested views (cfg["a"]["b"] = x) must
        # mutate the original tree, OmegaConf-style
        object.__setattr__(self, "_data",
                           data if isinstance(data, dict) else dict(data or {}))
        object.__setattr__(self, "_root", root)

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._wrap(key, self._data[key])

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self._wrap(key, self._data[key])
        except KeyError:
            raise AttributeError(f"Missing config key: {key!r}")

    def __setattr__(self, key: str, value: Any) -> None:
        if key.startswith("_"):
            object.__setattr__(self, key, value)
        else:
            self._data[key] = _unwrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _unwrap(value)

    # -- internals ----------------------------------------------------------
    def _wrap(self, key: str, value: Any) -> Any:
        if isinstance(value, dict):
            return Config(value, root=self._root or self)
        if isinstance(value, str):
            if value == MISSING:
                raise MissingMandatoryValue(
                    f"Missing mandatory value for key {key!r} (set it via override)")
            return self._resolve_str(value)
        return value

    def _resolve_str(self, value: str) -> Any:
        root = self._root or self

        def repl(m: re.Match) -> str:
            expr = m.group(1)
            if expr.startswith("now:"):
                return datetime.datetime.now().strftime(expr[4:])
            node: Any = root
            for part in expr.split("."):
                node = node[part]
            return str(node)

        if not _INTERP_RE.search(value):
            return value
        # Full-string single interpolation keeps the referenced value's type.
        full = _INTERP_RE.fullmatch(value)
        if full and not full.group(1).startswith("now:"):
            node: Any = root
            for part in full.group(1).split("."):
                node = node[part]
            if isinstance(node, str):
                return self._resolve_str(node)
            return node
        return _INTERP_RE.sub(repl, value)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except (KeyError, MissingMandatoryValue):
            return default

    def to_dict(self, resolve: bool = True) -> dict:
        if not resolve:
            return copy.deepcopy(self._data)
        out: dict = {}
        for k in self._data:
            v = self._wrap(k, self._data[k])
            out[k] = v.to_dict() if isinstance(v, Config) else v
        return out

    def to_yaml(self, resolve: bool = True) -> str:
        import yaml
        return yaml.safe_dump(self.to_dict(resolve=resolve), sort_keys=False)

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self._wrap(k, v)) for k, v in self._data.items()]

    def values(self):
        return [self._wrap(k, v) for k, v in self._data.items()]

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def _unwrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value.to_dict(resolve=False)
    return value


def _set_dotted(tree: dict, dotted: str, value: Any, *, allow_new: bool) -> None:
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            if not allow_new and p not in node:
                raise KeyError(
                    f"Override key {dotted!r} not in config (use +{dotted} to add)")
            node[p] = node.get(p) if isinstance(node.get(p), dict) else {}
        node = node[p]
    leaf = parts[-1]
    if not allow_new and leaf not in node:
        raise KeyError(f"Override key {dotted!r} not in config (use +{dotted} to add)")
    node[leaf] = value


def _parse_value(raw: str) -> Any:
    import yaml
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def load_config(config_path: str | Path,
                overrides: list[str] | None = None,
                model_group_dir: str | Path | None = None) -> Config:
    """Load a root YAML config, apply `model=<name>` group + dotted overrides.

    Mirrors the Hydra override grammar used throughout `runner.sh:91-102`.
    """
    import yaml
    config_path = Path(config_path)
    with open(config_path) as f:
        tree = yaml.safe_load(f) or {}
    tree.pop("hydra", None)
    tree.pop("defaults", None)

    overrides = list(overrides or [])
    if model_group_dir is None:
        model_group_dir = config_path.parent / "model"

    rest = []
    for ov in overrides:
        if ov.startswith("model=") and "." not in ov.split("=", 1)[0]:
            name = ov.split("=", 1)[1]
            fn = Path(model_group_dir, f"{name}.yaml")
            with open(fn) as f:
                model_tree = yaml.safe_load(f) or {}
            tree["model"] = model_tree
        else:
            rest.append(ov)

    for ov in rest:
        allow_new = ov.startswith("+")
        if allow_new:
            ov = ov[1:]
        if "=" not in ov:
            raise ValueError(f"Malformed override (expected key=value): {ov!r}")
        key, raw = ov.split("=", 1)
        _set_dotted(tree, key, _parse_value(raw), allow_new=allow_new)

    return Config(tree)


def config_from_dict(tree: dict) -> Config:
    return Config(copy.deepcopy(tree))
