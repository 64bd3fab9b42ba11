"""Python-file config system with `_base_` inheritance.

Own copy of `cdsegnet_tpu/engine/config.py`, a minimal mmcv-style `Config`
(reference `pointcept/utils/config.py:33-694`): a config is a Python file
executed in an isolated namespace; `_base_` lists parent configs merged
recursively (child wins; a dict value of `_delete_=True` replaces instead of
merging). CLI overrides use dotted `key=value` strings.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List, Optional


class Config(dict):
    """dict with attribute access and deep merge."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config({k: Config._wrap(x) for k, x in v.items()})
        if isinstance(v, list):
            return [Config._wrap(x) for x in v]
        return v

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        cfg = _load_py(path)
        return cls(cls._wrap(cfg))

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        for key, val in options.items():
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, Config())
            node[parts[-1]] = self._wrap(val)

    def dump(self, path: str) -> None:
        import pprint

        with open(path, "w") as f:
            f.write(pprint.pformat(dict(self), width=100))

    def copy(self) -> "Config":
        return Config(copy.deepcopy(dict(self)))


def _merge(base: Dict, child: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in child.items():
        if (
            isinstance(v, dict)
            and k in out
            and isinstance(out[k], dict)
            and not v.pop("_delete_", False)
        ):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _load_py(path: str) -> Dict:
    path = os.path.abspath(path)
    ns: Dict[str, Any] = {}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, "exec"), ns)
    cfg = {
        k: v for k, v in ns.items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
    }
    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        merged = _merge(merged, _load_py(os.path.join(os.path.dirname(path), b)))
    return _merge(merged, cfg)


def parse_options(opts: Optional[List[str]]) -> Dict[str, Any]:
    """Parse CLI `key=value` overrides with literal-eval values."""
    out: Dict[str, Any] = {}
    for opt in opts or []:
        key, _, val = opt.partition("=")
        try:
            out[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            out[key] = val
    return out
