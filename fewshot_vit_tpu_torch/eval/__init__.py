from .emd_eval import evaluate_emd, group_episode_indices, sample_emd_episode_indices
from .episodic import encode_dataset, evaluate, evaluate_cached, sample_episode_indices
from .visualize import attention_maps, overlay, real_attention_maps

__all__ = ["attention_maps", "encode_dataset", "evaluate", "evaluate_cached", "evaluate_emd",
           "group_episode_indices", "overlay", "real_attention_maps",
           "sample_emd_episode_indices", "sample_episode_indices"]
