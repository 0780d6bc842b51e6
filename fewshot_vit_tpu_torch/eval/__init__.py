from .emd_eval import evaluate_emd, group_episode_indices, sample_emd_episode_indices
from .episodic import encode_dataset, evaluate, evaluate_cached, sample_episode_indices

__all__ = ["encode_dataset", "evaluate", "evaluate_cached", "evaluate_emd",
           "group_episode_indices", "sample_emd_episode_indices", "sample_episode_indices"]
