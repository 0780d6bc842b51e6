"""Encoder zoo. Importing this package registers the encoders."""

from .common import global_avg_pool
from .visformer import Visformer

__all__ = ["Visformer", "global_avg_pool"]
