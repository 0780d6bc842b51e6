"""The least time of Swin's window attention, from a configuration's widths.

The work is what the program's ``encoder.window_attn`` span holds, one a
block: the qkv projection, the attention of every window, the output
projection, and the roll, partition and reverse around them. A window of
n = M^2 tokens by C channels does 8 n C^2 flops in the two projections
(3C and C outputs) and 4 n^2 C in q k^T and the weighted sum of v. The
span reads its input (the block's normed tokens) and writes its output
once, n C elements each a window, and reads the block's weights (qkv and
proj kernels and biases, the relative position bias table) once a forward.
q, k, v, the scores and o are intermediates a fused kernel keeps on chip;
the roll, partition and reverse are indexing; the bias, mask and softmax
are elementwise. A block's least time is the larger of its bytes over HBM
and its flops over the dtype's tensor-core peak, as ``roofline.bound``
takes them. A later fused window kernel is judged on this same work.
"""

from __future__ import annotations

from typing import List, Tuple

from .roofline import ELEMENT_BYTES, HBM_BYTES_PER_S, PEAK_3XTF32, PEAK_FLOPS


def blocks(cfg: dict) -> List[Tuple[int, int, int, int]]:
    """(windows an image, heads, tokens a window, head dim) of every block,
    in order; a stage whose grid is no larger than the window is one
    window."""
    r = int(cfg["img_size"]) // int(cfg["patch_size"])
    m, c = int(cfg["window_size"]), int(cfg["embed_dim"])
    out = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        w = min(m, r)
        d = c * 2 ** i
        out += [((r // w) ** 2, int(heads), w * w, d // int(heads))] * int(depth)
        r //= 2
    return out


def windows_per_image(cfg: dict) -> int:
    return sum(b[0] for b in blocks(cfg))


def weight_elements(cfg: dict, heads: int, n: int, c: int) -> int:
    """A block's qkv and proj kernels and biases and its bias table of
    (2M - 1)^2 entries a head, M = sqrt(n)."""
    qkv_bias = 3 * c if cfg.get("qkv_bias", True) else 0
    m = int(round(n ** 0.5))
    return 4 * c * c + qkv_bias + c + (2 * m - 1) ** 2 * heads


def window_attention_bound(cfg: dict, windows: float, forwards: float, dtype: str) -> float:
    """Least ms of the window attention of ``windows`` windows counted over
    ``forwards`` whole forwards (``windows_per_image`` an image each)."""
    images = windows / windows_per_image(cfg)
    e = ELEMENT_BYTES[dtype]
    peak = PEAK_3XTF32 if dtype == "float32" else PEAK_FLOPS[dtype]
    total = 0.0
    for per_image, heads, n, hd in blocks(cfg):
        c = heads * hd
        w = images * per_image
        bytes_ = (w * 2 * n * c + forwards * weight_elements(cfg, heads, n, c)) * e
        flops = w * (8 * n * c * c + 4 * n * n * c)
        total += max(bytes_ / HBM_BYTES_PER_S, flops / peak)
    return total * 1e3
