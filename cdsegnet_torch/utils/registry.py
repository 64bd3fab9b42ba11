"""Minimal registry + build-from-config ("type" key) pattern.

The port's own copy of `cdsegnet_tpu/utils/registry.py`: every config node
carries a ``type`` key resolved against a named registry.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._registry: Dict[str, Callable] = {}

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None):
        if module is not None:
            self._registry[name or module.__name__] = module
            return module

        def deco(cls):
            self._registry[name or cls.__name__] = cls
            return cls

        return deco

    def get(self, key: str) -> Callable:
        if key not in self._registry:
            raise KeyError(f"{key!r} not found in registry {self.name!r}; "
                           f"known: {sorted(self._registry)}")
        return self._registry[key]

    def __contains__(self, key: str) -> bool:
        return key in self._registry

    def build(self, cfg: Dict[str, Any], /, **extra) -> Any:
        # `cfg` is positional-only: consumers like the tester take a `cfg=`
        # kwarg of their own, passed through **extra
        if not isinstance(cfg, dict) or "type" not in cfg:
            raise TypeError(f"config must be a dict with a 'type' key, got {cfg!r}")
        cfg = dict(cfg)
        kind = cfg.pop("type")
        fn = self.get(kind)
        sig = None
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            pass
        kwargs = {**cfg, **extra}
        if sig is not None and not any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
        ):
            kwargs = {k: v for k, v in kwargs.items() if k in sig.parameters}
        # config files produce lists; convert scalar lists to tuples, leave
        # dict-valued lists alone
        kwargs = {
            k: tuple(v)
            if isinstance(v, list) and not any(isinstance(x, dict) for x in v)
            else v
            for k, v in kwargs.items()
        }
        return fn(**kwargs)
