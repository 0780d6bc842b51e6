from .episodes import make_nk_label, split_shot_query
from .emd import emd_distance, normalize_weights, sinkhorn
from .metric import (
    compute_acc,
    compute_logits,
    l2_normalize,
    mean_confidence_interval,
    normal_confidence_interval,
    per_episode_acc,
    roc_auc,
)

__all__ = ["compute_acc", "compute_logits", "emd_distance", "l2_normalize", "make_nk_label",
           "mean_confidence_interval", "normal_confidence_interval",
           "normalize_weights", "per_episode_acc", "roc_auc", "sinkhorn", "split_shot_query"]
