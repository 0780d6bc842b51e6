from .episodic import encode_dataset, evaluate, evaluate_cached, sample_episode_indices

__all__ = ["encode_dataset", "evaluate", "evaluate_cached", "sample_episode_indices"]
