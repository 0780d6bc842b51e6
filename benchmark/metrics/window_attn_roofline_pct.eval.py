"""The least time of the window attention the program's ``encoder.windows``
counter says it ran (``roofline_window.window_attention_bound`` from the
configuration's widths: the projections and the attention, the span's input
and output and its weights), over the device time of its
``encoder.window_attn`` spans, which hold that same work."""

from benchmark.metrics._program_trace import _spans
from benchmark.roofline_window import blocks, window_attention_bound


def read(run):
    attn = _spans(run, "eval", "encoder.window_attn")
    cfg = run.extra.get("encoder_args")
    if not attn or cfg is None:
        return None
    windows = sum(s["counts"].get("encoder.windows", 0) for s in attn)
    spent = sum(s["device_ms"] for s in attn)
    if not windows or spent <= 0:
        return None
    forwards = len(attn) / len(blocks(cfg))
    return 100.0 * window_attention_bound(cfg, windows, forwards, run.extra["dtype"]) / spent
