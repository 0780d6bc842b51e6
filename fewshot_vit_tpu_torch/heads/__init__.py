"""Few-shot heads. Importing this package registers the heads."""

from .meta_baseline import MetaBaseline

__all__ = ["MetaBaseline"]
