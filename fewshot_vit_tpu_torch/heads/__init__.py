"""Few-shot heads. Importing this package registers the heads."""

from .deepemd import DeepEMD
from .meta_baseline import MetaBaseline

__all__ = ["DeepEMD", "MetaBaseline"]
