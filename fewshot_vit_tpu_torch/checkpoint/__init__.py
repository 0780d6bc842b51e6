from .from_flax import from_flax, load_flax, visformer_key
from .io import CheckpointPolicy, has_checkpoint, load_variables, save_variables

__all__ = ["CheckpointPolicy", "from_flax", "has_checkpoint", "load_flax",
           "load_variables", "save_variables", "visformer_key"]
