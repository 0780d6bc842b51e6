"""String -> constructor registries (counterpart: ``fewshot_vit_tpu/core/registry.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """A named string->constructor map with a decorator-style ``register``."""

    def __init__(self, kind: str):
        self.kind = kind
        self._ctors: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        def deco(ctor: Callable[..., Any]) -> Callable[..., Any]:
            if name in self._ctors:
                raise KeyError(f"{self.kind} registry: duplicate name {name!r}")
            self._ctors[name] = ctor
            return ctor

        return deco

    def make(self, name: str, **kwargs: Any) -> Any:
        if name not in self._ctors:
            raise KeyError(
                f"{self.kind} registry: unknown name {name!r}; "
                f"known: {sorted(self._ctors)}"
            )
        return self._ctors[name](**kwargs)


models = Registry("model")
datasets = Registry("dataset")
