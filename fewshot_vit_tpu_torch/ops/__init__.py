from .episodes import make_nk_label, split_shot_query
from .metric import compute_logits, l2_normalize, mean_confidence_interval, per_episode_acc

__all__ = ["compute_logits", "l2_normalize", "make_nk_label",
           "mean_confidence_interval", "per_episode_acc", "split_shot_query"]
