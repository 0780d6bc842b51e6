"""YAML configs for the CLI (counterpart: ``fewshot_vit_tpu/core/config.py``).

Dotted-path ``get`` over a nested dict, ``updated`` overrides, and a
snapshot dump. ``yaml`` is imported when a file is read or written, not with
the module.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional


class Config:
    """Nested dict with dotted-path lookup: ``cfg.get('model_args.encoder')``."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data = dict(data or {})

    def get(self, key: str, default: Any = None) -> Any:
        node: Any = self._data
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def updated(self, overrides: Dict[str, Any]) -> "Config":
        """A new Config with dotted-path overrides applied."""
        data = copy.deepcopy(self._data)
        for key, value in overrides.items():
            node = data
            parts = key.split(".")
            for i, p in enumerate(parts[:-1]):
                node = node.setdefault(p, {})
                if not isinstance(node, dict):
                    raise ValueError(
                        f"override {key!r} descends through "
                        f"{'.'.join(parts[: i + 1])!r}, which is the scalar "
                        f"{node!r}, not a mapping")
            node[parts[-1]] = value
        return Config(data)

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def dump_yaml(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self._data, f, sort_keys=False)


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a YAML config file, optionally applying dotted-path overrides."""
    import yaml

    with open(path) as f:
        cfg = Config(yaml.safe_load(f) or {})
    return cfg.updated(overrides) if overrides else cfg
