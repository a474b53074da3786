"""Config system: YAML files with attribute access and CLI-style overrides.

The port's own copy of dcl_net_tpu/config.py (the port imports nothing of
the JAX package), standing in for gorilla-core's ``gorilla.Config.fromfile``
of the original DCL-Net code.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Iterator, Mapping

import yaml


class Config(dict):
    """A dict with recursive attribute access, YAML IO and override merging.

    >>> cfg = Config({"model": {"n_inp": 1024}})
    >>> cfg.model.n_inp
    1024
    >>> cfg.exp_id = 3          # attribute writes work too
    >>> cfg["exp_id"]
    3
    """

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs: Any):
        super().__init__()
        merged: Dict[str, Any] = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = self._wrap(value)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._wrap(value)

    def __delattr__(self, name: str) -> None:
        del self[name]

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    # -- IO ------------------------------------------------------------------
    @classmethod
    def fromfile(cls, path: str) -> "Config":
        """Load a YAML config file (reference: gorilla.Config.fromfile)."""
        with open(path, "r") as f:
            data = yaml.safe_load(f) or {}
        if not isinstance(data, Mapping):
            raise ValueError(f"Config file {path} must contain a mapping at top level")
        return cls(data)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(value: Any) -> Any:
            if isinstance(value, Config):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, list):
                return [unwrap(v) for v in value]
            return value

        return {k: unwrap(v) for k, v in self.items()}

    def __repr__(self) -> str:
        return f"Config({json.dumps(self.to_dict(), indent=2, default=str)})"

    # -- merging ---------------------------------------------------------------
    def merge(self, other: Mapping[str, Any]) -> "Config":
        """Recursively merge ``other`` into a copy of self (other wins)."""
        out = Config(copy.deepcopy(self.to_dict()))
        for key, value in other.items():
            if (
                key in out
                and isinstance(out[key], Config)
                and isinstance(value, Mapping)
            ):
                out[key] = out[key].merge(value)
            else:
                out[key] = self._wrap(copy.deepcopy(value))
        return out

    def apply_overrides(self, overrides: Iterator[str] | list[str]) -> "Config":
        """Apply ``key.subkey=value`` CLI overrides (values parsed as YAML)."""
        out = Config(copy.deepcopy(self.to_dict()))
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"Override '{item}' is not of form key=value")
            key, _, raw = item.partition("=")
            value = yaml.safe_load(raw)
            node = out
            parts = key.strip().split(".")
            for part in parts[:-1]:
                if part not in node or not isinstance(node[part], Config):
                    node[part] = Config()
                node = node[part]
            node[parts[-1]] = Config._wrap(value)
        return out
