"""YAML configs for the CLI (counterpart: ``fewshot_vit_tpu/core/config.py``).

Only the read side the eval CLI needs: dotted-path ``get`` over a nested
dict. ``yaml`` is imported when a file is loaded, not with the module.
"""

from __future__ import annotations

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


def load_config(path: str) -> Config:
    """Load a YAML config file."""
    import yaml

    with open(path) as f:
        return Config(yaml.safe_load(f) or {})
