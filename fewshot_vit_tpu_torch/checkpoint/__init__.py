from .from_flax import from_flax, load_flax, visformer_key

__all__ = ["from_flax", "load_flax", "visformer_key"]
