from .device import resolve_device
from .registry import Registry, datasets, models
from .watchdog import watchdog_reexec

__all__ = ["Registry", "datasets", "models", "resolve_device", "watchdog_reexec"]
