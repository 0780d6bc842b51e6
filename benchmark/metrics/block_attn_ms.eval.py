"""Device ms per batch of NesT's block attention: the program's
``encoder.block_attn`` spans (the qkv projection, the attention within each
block, the proj projection; one a transformer layer), summed, over the
number of ``eval.batch`` spans beside them."""

from benchmark.metrics._program_trace import _spans


def read(run):
    attn = _spans(run, "eval", "encoder.block_attn")
    batches = _spans(run, "eval", "eval.batch")
    if not attn or not batches:
        return None
    return sum(s["device_ms"] for s in attn) / len(batches)
