"""The least time of the LayerNorms the program's ``encoder.norm`` spans
hold, over the spans' device time, in percent.

A span holds one LayerNorm call from the compute dtype to the compute dtype
(on the plain path with its casts to fp32 and back). Its least time is its
bytes over HBM: every element read once and written once in the cell's
dtype (the counter ``encoder.norm_elems``). The calls' fp32 weights and
biases are left out: 99 KB a Swin-T forward, against 38 GB of rows in a
forward of 2,560 images. The statistics and the affine are a few flops an
element, far under the card's flops a byte."""

from benchmark.metrics._program_trace import _spans
from benchmark.roofline import ELEMENT_BYTES, HBM_BYTES_PER_S


def read(run):
    norms = _spans(run, "eval", "encoder.norm")
    elems = sum(s["counts"].get("encoder.norm_elems", 0) for s in norms)
    spent = sum(s["device_ms"] for s in norms)
    if not elems or spent <= 0:
        return None
    bytes_ = elems * 2 * ELEMENT_BYTES[run.extra["dtype"]]
    return 100.0 * bytes_ / HBM_BYTES_PER_S * 1e3 / spent
