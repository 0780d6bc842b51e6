"""The yardstick's arithmetic: the H100's peaks and the least time of a
kernel call from its shapes.

``bound`` and ``sinkhorn_bound`` are frozen copies of ``chip_smoke.py``'s
``_bound`` and ``_sinkhorn_bound`` (the repository's kernel checks), with
their peaks; ``tests/test_bench_arith.py`` holds them equal at that script's
phase-7 shapes. They count what a call must do whatever kernel serves it:
q, k, v read and o written once, 4 T^2 hd flops per (batch, head); the
Sinkhorn's cost and marginals read and its flow written once, and its exp
and log count on the special-function units.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# dense tensor-core bf16, and fp32 outside the tensor cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# dense TF32 on the tensor cores: the peak of an fp32 model whose convolutions
# cuDNN may run as TF32, so that no legal change of kernel reads above 100%
PEAK_TF32 = 494.7e12
# fp32 as 3xTF32 on the tensor cores: three products at the TF32 rate for each
PEAK_3XTF32 = PEAK_TF32 / 3
# special-function units: 16 exp2/log2 results per clock per SM on compute
# capability 9.0, 132 SMs at the 1.98 GHz boost clock
SFU_PER_S = 132 * 16 * 1.98e9
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def model_peak(dtype: str) -> float:
    """The FLOP/s that a step's model FLOPs are held against: bf16 on the
    tensor cores, or dense TF32 for an fp32 configuration."""
    return PEAK_FLOPS["bfloat16"] if dtype == "bfloat16" else PEAK_TF32


def bound(b: int, h: int, t: int, hd: int, dtype: str) -> Tuple[float, str]:
    """Least ms of one attention call over (b, h, t, hd) in ``dtype``: the
    larger of its bytes over HBM and its flops over the dtype's tensor-core
    peak (3xTF32 for fp32), and which of the two it is."""
    bytes_ = 4 * b * h * t * hd * ELEMENT_BYTES[dtype]
    flops = 4 * b * h * t * t * hd
    peak = PEAK_3XTF32 if dtype == "float32" else PEAK_FLOPS[dtype]
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def sinkhorn_bound(b: int, n1: int, n2: int, iters: int) -> Tuple[float, str]:
    """Least ms of one Sinkhorn call: cost, w1, w2 read once and the flow
    written once over HBM, or the larger of its exp/log count over the
    special-function rate and its other fp32 operations (add, max, subtract,
    sum per element per half-round) over the fp32 rate."""
    bytes_ = 4 * b * (2 * n1 * n2 + n1 + n2)
    sfu = b * (iters * (2 * n1 * n2 + n1 + n2) + n1 * n2 + n1 + n2)
    flops = b * iters * 2 * n1 * n2 * 4
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = max(sfu / SFU_PER_S, flops / PEAK_FLOPS["float32"]) * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")
