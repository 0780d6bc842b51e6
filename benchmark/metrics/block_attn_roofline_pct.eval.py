"""The least time of the block attention the program's ``encoder.blocks``
counter says it ran (``roofline_block.block_attention_bound`` from the
configuration's widths: the projections and the attention, the span's input
and output and its weights), over the device time of its
``encoder.block_attn`` spans, which hold that same work."""

from benchmark.metrics._program_trace import _spans
from benchmark.roofline_block import block_attention_bound, layers


def read(run):
    attn = _spans(run, "eval", "encoder.block_attn")
    cfg = run.extra.get("encoder_args")
    if not attn or cfg is None:
        return None
    blocks = sum(s["counts"].get("encoder.blocks", 0) for s in attn)
    spent = sum(s["device_ms"] for s in attn)
    if not blocks or spent <= 0:
        return None
    forwards = len(attn) / len(layers(cfg))
    return 100.0 * block_attention_bound(cfg, blocks, forwards, run.extra["dtype"]) / spent
