"""Hand-written CUDA kernels (``csrc/``) and their wrappers."""

from .attention import attention_core, fused_mhsa, fused_mhsa_reference

__all__ = ["attention_core", "fused_mhsa", "fused_mhsa_reference"]
