"""Device ms per batch of LeViT's biased attention: the program's
``encoder.bias_attn`` spans (the qkv, or kv and q, projections, the biased
attention, the hard-swish and the proj projection; one an attention call,
8 a ``levit_micro_80`` forward), summed, over the number of ``eval.batch``
spans beside them."""

from benchmark.metrics._program_trace import _spans


def read(run):
    attn = _spans(run, "eval", "encoder.bias_attn")
    batches = _spans(run, "eval", "eval.batch")
    if not attn or not batches:
        return None
    return sum(s["device_ms"] for s in attn) / len(batches)
