"""Device ms per batch of Swin's window attention: the program's
``encoder.window_attn`` spans (roll, partition, attention with its
projections, reverse, roll back; one a block), summed, over the number of
``eval.batch`` spans beside them."""

from benchmark.metrics._program_trace import _spans


def read(run):
    attn = _spans(run, "eval", "encoder.window_attn")
    batches = _spans(run, "eval", "eval.batch")
    if not attn or not batches:
        return None
    return sum(s["device_ms"] for s in attn) / len(batches)
