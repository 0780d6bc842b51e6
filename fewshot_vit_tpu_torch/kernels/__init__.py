"""Hand-written CUDA kernels (``csrc/``) and their wrappers. Importing this
package registers the custom ops ``fewshot_vit_tpu_torch::fused_mhsa``,
``::sinkhorn_pallas`` and ``::window_attention``, which an exported program
calls by name."""

from .attention import attention_core, fused_mhsa, fused_mhsa_reference, mhsa_op
from .sinkhorn import sinkhorn_op, sinkhorn_pallas, sinkhorn_reference
from .window import window_attention, window_attention_op, window_attention_reference

__all__ = ["attention_core", "fused_mhsa", "fused_mhsa_reference", "mhsa_op", "sinkhorn_op",
           "sinkhorn_pallas", "sinkhorn_reference", "window_attention", "window_attention_op",
           "window_attention_reference"]
