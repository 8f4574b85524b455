"""Minimal OmegaConf-compatible config container.

A copy of ``convofusion_tpu/config/omega.py:1-196``: attribute/item access,
deep merge, ``${a.b.c}`` interpolation resolved against the root tree, YAML
load/dump and dotlist overrides, with the same observable behavior for the
reference's YAML files.  The port keeps its own copy and imports nothing of
the JAX package.
"""
from __future__ import annotations

import copy
import re
from typing import Any, Iterator, Mapping

import yaml

_INTERP = re.compile(r"\$\{([^}]+)\}")


class DictConfig(Mapping):
    """Dict-like node with attribute access and lazy interpolation."""

    def __init__(self, data: dict, root: "DictConfig" = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_root", root if root is not None else self)
        for k, v in (data or {}).items():
            self[k] = v

    # -- construction helpers
    def _wrap(self, v):
        if isinstance(v, DictConfig):
            return DictConfig(v._data, root=self._root)
        if isinstance(v, Mapping):
            return DictConfig(dict(v), root=self._root)
        if isinstance(v, list):
            return [self._wrap(x) for x in v]
        return v

    def _reroot(self, root):
        object.__setattr__(self, "_root", root)
        for v in self._data.values():
            if isinstance(v, DictConfig):
                v._reroot(root)

    # -- resolution
    def _resolve_path(self, path: str):
        node: Any = self._root
        for part in path.split("."):
            if isinstance(node, DictConfig):
                node = node[part]
            elif isinstance(node, list):
                node = node[int(part)]
            else:
                raise KeyError(path)
        return node

    def _resolve(self, v):
        if isinstance(v, str):
            m = _INTERP.fullmatch(v.strip())
            if m:
                return self._resolve_path(m.group(1))
            if _INTERP.search(v):
                return _INTERP.sub(
                    lambda m: str(self._resolve_path(m.group(1))), v)
        if isinstance(v, list):
            return [self._resolve(x) for x in v]
        return v

    # -- mapping protocol
    def __getitem__(self, key):
        return self._resolve(self._data[key])

    def __setitem__(self, key, value):
        self._data[key] = self._wrap(value)

    def __delitem__(self, key):
        del self._data[key]

    def __contains__(self, key):
        return key in self._data

    def __iter__(self) -> Iterator:
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def get(self, key, default=None):
        return self[key] if key in self._data else default

    # -- attribute access
    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        if key.startswith("_"):
            object.__setattr__(self, key, value)
        else:
            self[key] = value

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self[k]) for k in self._data]

    def values(self):
        return [self[k] for k in self._data]

    # -- merge / convert
    def merge_with(self, other):
        src = other._data if isinstance(other, DictConfig) else other
        for k, v in src.items():
            if (
                k in self._data
                and isinstance(self._data[k], DictConfig)
                and isinstance(v, (Mapping, DictConfig))
            ):
                self._data[k].merge_with(v)
            else:
                self[k] = copy.deepcopy(
                    v._data if isinstance(v, DictConfig) else v)
        return self

    def to_container(self, resolve: bool = True):
        out = {}
        for k in self._data:
            v = self[k] if resolve else self._data[k]
            if isinstance(v, DictConfig):
                v = v.to_container(resolve)
            elif isinstance(v, list):
                v = [x.to_container(resolve) if isinstance(x, DictConfig)
                     else x for x in v]
            out[k] = v
        return out

    def __repr__(self):
        return f"DictConfig({self.to_container(resolve=False)!r})"


class OmegaConf:
    """Namespace mirroring the OmegaConf entry points the reference uses."""

    @staticmethod
    def create(data=None) -> DictConfig:
        return DictConfig(data or {})

    @staticmethod
    def load(file) -> DictConfig:
        if hasattr(file, "read"):
            return DictConfig(yaml.safe_load(file) or {})
        with open(file) as f:
            return DictConfig(yaml.safe_load(f) or {})

    @staticmethod
    def merge(*configs) -> DictConfig:
        out = DictConfig({})
        for c in configs:
            out.merge_with(c)
        out._reroot(out)
        return out

    @staticmethod
    def from_dotlist(dotlist) -> DictConfig:
        out = DictConfig({})
        for item in dotlist:
            key, _, value = item.partition("=")
            node = out
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = {}
                node = node[p]
            node[parts[-1]] = yaml.safe_load(value)
        return out

    @staticmethod
    def to_container(cfg, resolve: bool = True):
        return cfg.to_container(resolve)

    @staticmethod
    def save(cfg, path):
        with open(path, "w") as f:
            yaml.safe_dump(cfg.to_container(resolve=False), f,
                           sort_keys=False)

    @staticmethod
    def to_yaml(cfg) -> str:
        return yaml.safe_dump(cfg.to_container(resolve=False),
                              sort_keys=False)
