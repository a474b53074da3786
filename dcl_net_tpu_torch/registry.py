"""Registries of models and datasets (counterpart of dcl_net_tpu/registry.py).

The reference resolves model and dataset classes by module name through
importlib (reference tools/train_YCBV_stage1.py:249-250, 259-260). Here, as
in the JAX package, a class registers under its config name: models under
cfg.model.name (DCL_Net, Refiner), datasets under cfg.hyper_dataset_*.name
(synthetic, ycbv_train, ycbv_test, linemod, lmo). A name registers once, and
an unknown name raises KeyError with the names there are.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None) -> Callable[[Any], Any]:
        def deco(obj: Any) -> Any:
            key = name or obj.__name__
            if key in self._entries:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._entries[key] = obj
            return obj

        return deco

    def get(self, name: str) -> Any:
        if name not in self._entries:
            raise KeyError(
                f"{name!r} not found in registry {self.name}; "
                f"available: {sorted(self._entries)}"
            )
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def keys(self) -> Iterable[str]:
        return self._entries.keys()


MODELS = Registry("models")
DATASETS = Registry("datasets")
