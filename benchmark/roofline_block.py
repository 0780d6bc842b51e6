"""The least time of NesT's block attention, from a configuration's widths.

The work is what the program's ``encoder.block_attn`` span holds, one a
transformer layer: the qkv projection, the attention within every block and
the output projection. A block of n tokens by C channels does 8 n C^2
flops in the two projections (3C and C outputs) and 4 n^2 C in q k^T and
the weighted sum of v. The span reads its input (the layer's normed tokens)
and writes its output once, n C elements each a block, and reads the
layer's weights (qkv and proj kernels and biases) once a forward. q, k, v,
the scores and o are intermediates a fused kernel keeps on chip; the scale
and softmax are elementwise. A layer's least time is the larger of its
bytes over HBM and its flops over the dtype's tensor-core peak, as
``roofline.bound`` takes them, and as ``roofline_window.py`` takes a Swin
block's. A later fused block kernel is judged on this same work.
"""

from __future__ import annotations

from typing import List, Tuple

from .reference.nest import levels
from .roofline import ELEMENT_BYTES, HBM_BYTES_PER_S, PEAK_3XTF32, PEAK_FLOPS


def layers(cfg: dict) -> List[Tuple[int, int, int, int]]:
    """(blocks an image, heads, tokens a block, head dim) of every
    transformer layer, in order, from the reference's table of levels."""
    return [(blocks, heads, edge * edge, c // heads)
            for blocks, edge, c, heads, depth in levels(cfg) for _ in range(depth)]


def blocks_per_image(cfg: dict) -> int:
    return sum(layer[0] for layer in layers(cfg))


def weight_elements(cfg: dict, c: int) -> int:
    """A layer's qkv and proj kernels and biases."""
    return 4 * c * c + (3 * c if cfg.get("qkv_bias", True) else 0) + c


def block_attention_bound(cfg: dict, blocks: float, forwards: float, dtype: str) -> float:
    """Least ms of the block attention of ``blocks`` blocks counted over
    ``forwards`` whole forwards (``blocks_per_image`` an image each)."""
    images = blocks / blocks_per_image(cfg)
    e = ELEMENT_BYTES[dtype]
    peak = PEAK_3XTF32 if dtype == "float32" else PEAK_FLOPS[dtype]
    total = 0.0
    for per_image, heads, n, hd in layers(cfg):
        c = heads * hd
        w = images * per_image
        bytes_ = (w * 2 * n * c + forwards * weight_elements(cfg, c)) * e
        flops = w * (8 * n * c * c + 4 * n * n * c)
        total += max(bytes_ / HBM_BYTES_PER_S, flops / peak)
    return total * 1e3
