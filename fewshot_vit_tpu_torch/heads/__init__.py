"""Few-shot and classification heads. Importing this package registers the heads."""

from .classifier import Classifier, LinearClassifier, NNClassifier
from .deepemd import DeepEMD
from .meta_baseline import MetaBaseline
from .meta_token import MetaToken, MetaTokenV2, MetaTokenV3
from .token_label import (
    TokenLabel,
    TokenLabelEpisodic,
    TokenLabelEpisodicChannelAttn,
    TokenLabelEpisodicReweight,
    TokenLabelV2,
)

__all__ = ["Classifier", "DeepEMD", "LinearClassifier", "MetaBaseline", "MetaToken",
           "MetaTokenV2", "MetaTokenV3", "NNClassifier", "TokenLabel", "TokenLabelEpisodic",
           "TokenLabelEpisodicChannelAttn", "TokenLabelEpisodicReweight", "TokenLabelV2"]
