"""Hydra-style composition of the repo's ``configs/`` tree (port of
``irw_tpu/config/compose.py:33-306``, reading YAML with ``yaml_lite``).

- ``defaults:`` in the root config: ``- group: option`` loads
  ``<config_dir>/<group>/<option>.yaml`` under key ``group`` (a list-valued
  file, as the loss group, becomes that list); ``- _self_`` places the
  root's own keys in the merge order; ``option: null`` drops the group.
- A group file may carry its own ``defaults`` list (nested groups).
- ``${a.b.c}`` interpolation against the merged tree, also inside lists
  and strings.
- CLI overrides: ``group=option`` swaps a group file, ``a.b.c=value`` sets
  an existing key (the value read as YAML), ``+a.b=v`` adds one, and
  ``a=1,2,3`` is a sweep that ``expand_sweeps`` turns into jobs.
"""

from __future__ import annotations

import copy
import itertools
import os
import re
from typing import Any, Iterator

from irw_tpu_torch.config.yaml_lite import load, loads


class Config(dict):
    """A dict with attribute access, wrapping nested dicts as it stores them:
    ``cfg.model.kwargs.nbits`` is ``cfg["model"]["kwargs"]["nbits"]``; a
    missing attribute raises ``AttributeError``."""

    def __init__(self, data: dict | None = None):
        super().__init__()
        for key, value in (data or {}).items():
            self[key] = value

    @staticmethod
    def _wrap(value):
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, Config._wrap(value))

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __setattr__(self, key, value):
        self[key] = value

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, list):
                node = node[int(part)]
            elif isinstance(node, dict) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set_path(self, dotted: str, value, force_add: bool = False):
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if isinstance(node, list):
                node = node[int(part)]
                continue
            if part not in node:
                if not force_add:
                    raise KeyError(f"override path {dotted!r}: {part!r} not in config "
                                   f"(use +{dotted} to add)")
                node[part] = {}
            node = node[part]
        leaf = parts[-1]
        if isinstance(node, list):
            node[int(leaf)] = Config._wrap(value)
        else:
            if leaf not in node and not force_add:
                raise KeyError(f"override path {dotted!r}: {leaf!r} not in config "
                               f"(use +{dotted} to add)")
            node[leaf] = value

    def merge(self, other: dict) -> "Config":
        """Deep-merge ``other`` into self: dicts merge, anything else replaces."""
        for key, value in other.items():
            if key in self and isinstance(self[key], Config) and isinstance(value, dict):
                self[key].merge(value)
            else:
                self[key] = value
        return self

    def to_dict(self) -> dict:
        out = {}
        for key, value in self.items():
            if isinstance(value, Config):
                out[key] = value.to_dict()
            elif isinstance(value, list):
                out[key] = [v.to_dict() if isinstance(v, Config) else v for v in value]
            else:
                out[key] = value
        return out


def load_yaml(path: str) -> Config:
    data = load(path) or {}
    if not isinstance(data, dict):  # a list-valued group file (the loss group)
        return Config({"_list_": data})
    return Config(data)


def _load_group(config_dir: str, group: str, option: str) -> Config:
    path = os.path.join(config_dir, *group.split("/"), f"{option}.yaml")
    if not os.path.exists(path):
        raise FileNotFoundError(f"config group file not found: {path}")
    node = load_yaml(path)
    if "defaults" in node:
        defaults = node.pop("defaults")
        merged = Config()
        for entry in defaults:
            if entry == "_self_":
                merged.merge(node)
                node = Config()
                continue
            (sub_group, sub_option), = entry.items()
            sub = _load_group(config_dir, f"{group}/{sub_group}", str(sub_option))
            merged.merge({sub_group: sub})
        merged.merge(node)
        node = merged
    return node


_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class _Missing:
    pass


_MISSING = _Missing()


def _resolve_interpolations(node: Any, root: Config, _depth: int = 0) -> Any:
    if _depth > 16:
        raise ValueError("interpolation recursion too deep (cycle?)")
    if isinstance(node, Config):
        for key in list(node.keys()):
            node[key] = _resolve_interpolations(node[key], root, _depth)
        return node
    if isinstance(node, list):
        return [_resolve_interpolations(v, root, _depth) for v in node]
    if isinstance(node, str):
        full = _INTERP_RE.fullmatch(node)
        if full:
            value = root.get_path(full.group(1), default=_MISSING)
            if value is _MISSING:
                raise KeyError(f"interpolation ${{{full.group(1)}}} not found")
            return _resolve_interpolations(copy.deepcopy(value), root, _depth + 1)

        def _sub(match):
            value = root.get_path(match.group(1), default=_MISSING)
            if value is _MISSING:
                raise KeyError(f"interpolation ${{{match.group(1)}}} not found")
            return str(value)
        return _INTERP_RE.sub(_sub, node)
    return node


def parse_overrides(overrides: list[str]) -> tuple[dict, dict, dict]:
    """Split CLI overrides into (group swaps, dotted sets, forced adds).
    Sweep values stay as written: ``expand_sweeps`` first for a multirun."""
    groups, sets, adds = {}, {}, {}
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must be key=value")
        key, _, value = item.partition("=")
        force_add = key.startswith("+")
        key = key.lstrip("+")
        if "." not in key and not force_add:
            # a group swap, or a root-level key (compose tells them apart)
            groups[key] = value
        elif force_add:
            adds[key] = loads(value)
        else:
            sets[key] = loads(value)
    return groups, sets, adds


def expand_sweeps(overrides: list[str]) -> Iterator[list[str]]:
    """``k=a,b,c`` overrides → the cross product of jobs (Hydra's ``-m``); a
    bracketed or quoted value is one value, not a sweep."""
    fixed, sweeps = [], []
    for item in overrides:
        key, _, value = item.partition("=")
        if "," in value and not value.startswith(("[", "{", '"', "'")):
            sweeps.append([(key, v) for v in value.split(",")])
        else:
            fixed.append(item)
    if not sweeps:
        yield list(fixed)
        return
    for combo in itertools.product(*sweeps):
        yield fixed + [f"{k}={v}" for k, v in combo]


def compose(config_dir: str, config_name: str = "default", overrides: list[str] | None = None,
            resolve: bool = True) -> Config:
    """``<config_dir>/<config_name>.yaml`` with its ``defaults`` (group swaps
    applied), its own keys, the dotted overrides, then the interpolations."""
    overrides = list(overrides or [])
    root_node = load_yaml(os.path.join(config_dir, f"{config_name}.yaml"))
    defaults = root_node.pop("defaults", [])
    group_swaps, dotted_sets, forced_adds = parse_overrides(overrides)

    composed = Config()
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            composed.merge(root_node)
            self_merged = True
            continue
        (group, option), = entry.items()
        option = group_swaps.pop(group, option)
        if option is None:
            continue
        group_cfg = _load_group(config_dir, group, str(option))
        if "_list_" in group_cfg and len(group_cfg) == 1:
            composed[group] = group_cfg["_list_"]
        else:
            composed.merge({group: group_cfg})
    if not self_merged:
        composed.merge(root_node)

    # swaps of groups the defaults do not list, and root-level sets
    for key, value in group_swaps.items():
        if os.path.isdir(os.path.join(config_dir, key)):
            group_cfg = _load_group(config_dir, key, str(value))
            if "_list_" in group_cfg and len(group_cfg) == 1:
                composed[key] = group_cfg["_list_"]
            else:
                composed[key] = group_cfg
        else:
            composed.set_path(key, loads(value), force_add=True)

    for key, value in dotted_sets.items():
        composed.set_path(key, value, force_add=False)
    for key, value in forced_adds.items():
        composed.set_path(key, value, force_add=True)

    if resolve:
        _resolve_interpolations(composed, composed)
    return composed
