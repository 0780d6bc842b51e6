"""The least time of LeViT's biased attention, from a configuration's widths.

The work is what the program's ``encoder.bias_attn`` span holds, one an
attention call (``reference/levit.py::attentions``: the stages' attention
and the two subsampling attentions between them): the qkv GEMM, or the kv
and q GEMMs; q k^T and the weighted sum of v, 2 Nq Nkv h (kd + d) flops;
the proj GEMM. The bias gather and add, the scale, the softmax and the
hard-swish are elementwise and count no flops. The span reads its input
(the tokens, N C_in) and writes its output (Nq C_out) once an image, and
reads its weights once a forward: the linear kernels with their biases as
the folded program holds them, and the bias table. q, k, v, the scores and
o are intermediates a fused kernel keeps on chip. A call's least time is
the larger of its bytes over HBM and its flops over the dtype's
tensor-core peak, as ``roofline_block.py`` takes a NesT layer's.
"""

from __future__ import annotations

from typing import Tuple

from .reference.levit import Attn, attentions
from .roofline import ELEMENT_BYTES, HBM_BYTES_PER_S, PEAK_3XTF32, PEAK_FLOPS


def call_flops(a: Attn) -> int:
    """Flops of one attention call an image."""
    nq, nkv = a.res_q ** 2, a.res_kv ** 2
    if a.stride == 1:
        gemms = 2 * nkv * a.cin * a.heads * (2 * a.kd + a.d)
    else:
        gemms = 2 * nkv * a.cin * a.heads * (a.kd + a.d) + 2 * nq * a.cin * a.heads * a.kd
    return gemms + 2 * nq * nkv * a.heads * (a.kd + a.d) + 2 * nq * a.heads * a.d * a.cout


def call_elements(a: Attn) -> Tuple[int, int]:
    """(activation elements an image: input and output; weight elements a
    forward: kernels, biases and the bias table) of one call."""
    nq, nkv = a.res_q ** 2, a.res_kv ** 2
    width = a.heads * (2 * a.kd + a.d)  # qkv, or kv and q together
    weights = width * (a.cin + 1) + a.cout * (a.heads * a.d + 1) + a.heads * nkv
    return nkv * a.cin + nq * a.cout, weights


def bias_attention_bound(cfg: dict, images: float, forwards: float, dtype: str) -> float:
    """Least ms of the biased attention of ``images`` images over
    ``forwards`` forwards."""
    e = ELEMENT_BYTES[dtype]
    peak = PEAK_3XTF32 if dtype == "float32" else PEAK_FLOPS[dtype]
    total = 0.0
    for a in attentions(cfg):
        acts, weights = call_elements(a)
        bytes_ = (images * acts + forwards * weights) * e
        total += max(bytes_ / HBM_BYTES_PER_S, images * call_flops(a) / peak)
    return total * 1e3
