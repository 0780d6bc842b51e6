from .emd_eval import evaluate_emd, group_episode_indices, sample_emd_episode_indices
from .episodic import encode_dataset, evaluate, evaluate_cached, sample_episode_indices
from .export import (
    export_emd_episode_scorer,
    export_encoder,
    export_episode_scorer,
    load_exported,
    save_exported,
)
from .visualize import attention_maps, overlay, real_attention_maps

__all__ = ["attention_maps", "encode_dataset", "evaluate", "evaluate_cached", "evaluate_emd",
           "export_emd_episode_scorer", "export_encoder", "export_episode_scorer",
           "group_episode_indices", "load_exported", "overlay", "real_attention_maps",
           "sample_emd_episode_indices", "sample_episode_indices", "save_exported"]
