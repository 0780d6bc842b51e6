from .from_flax import from_flax, load_flax, visformer_key
from .io import CheckpointPolicy, has_checkpoint, load_model, load_variables, save_variables
from .reference import (
    encoder_key_fn_for,
    load_reference_encoder_checkpoint,
    load_reference_head_checkpoint,
    load_torch_state_dict,
    strip_prefix,
)

__all__ = ["CheckpointPolicy", "encoder_key_fn_for", "from_flax", "has_checkpoint",
           "load_flax", "load_model", "load_reference_encoder_checkpoint",
           "load_reference_head_checkpoint", "load_torch_state_dict", "load_variables",
           "save_variables", "strip_prefix", "visformer_key"]
