"""Hand-written CUDA kernels (``csrc/``) and their wrappers. Importing this
package registers the custom ops ``fewshot_vit_tpu_torch::fused_mhsa``,
``::sinkhorn_pallas``, ``::window_attention`` and ``::layer_norm``, which an
exported program calls by name. (``kernels.layer_norm`` is the module; its
function is ``kernels.layer_norm.layer_norm``.)"""

from .attention import attention_core, fused_mhsa, fused_mhsa_reference, mhsa_op
from .layer_norm import layer_norm_op, layer_norm_reference
from .sinkhorn import sinkhorn_op, sinkhorn_pallas, sinkhorn_reference
from .window import window_attention, window_attention_op, window_attention_reference

__all__ = ["attention_core", "fused_mhsa", "fused_mhsa_reference", "layer_norm_op",
           "layer_norm_reference", "mhsa_op", "sinkhorn_op", "sinkhorn_pallas",
           "sinkhorn_reference", "window_attention", "window_attention_op",
           "window_attention_reference"]
