from .device import resolve_device
from .registry import Registry, datasets, models

__all__ = ["Registry", "datasets", "models", "resolve_device"]
