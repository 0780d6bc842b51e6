from .episodes import make_nk_label, split_shot_query
from .emd import emd_distance, normalize_weights, sinkhorn
from .metric import (
    compute_acc,
    compute_acc_kshots,
    compute_logits,
    compute_logits_kshot,
    compute_logits_local_kshot,
    l2_normalize,
    mean_confidence_interval,
    normal_confidence_interval,
    per_episode_acc,
    roc_auc,
    softmax_kl_loss,
)

__all__ = ["compute_acc", "compute_acc_kshots", "compute_logits", "compute_logits_kshot",
           "compute_logits_local_kshot", "emd_distance", "l2_normalize", "make_nk_label",
           "mean_confidence_interval", "normal_confidence_interval", "normalize_weights",
           "per_episode_acc", "roc_auc", "sinkhorn", "softmax_kl_loss", "split_shot_query"]
