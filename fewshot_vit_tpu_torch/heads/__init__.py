"""Few-shot and classification heads. Importing this package registers the heads."""

from .classifier import Classifier, LinearClassifier, NNClassifier
from .deepemd import DeepEMD
from .meta_baseline import MetaBaseline
from .token_label import TokenLabel

__all__ = ["Classifier", "DeepEMD", "LinearClassifier", "MetaBaseline", "NNClassifier",
           "TokenLabel"]
