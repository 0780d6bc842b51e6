"""Device ms per batch of the encoder's LayerNorms: the program's
``encoder.norm`` spans (one a LayerNorm call, its casts included where the
call makes them), summed, over the number of ``eval.batch`` spans beside
them."""

from benchmark.metrics._program_trace import _spans


def read(run):
    norms = _spans(run, "eval", "encoder.norm")
    batches = _spans(run, "eval", "eval.batch")
    if not norms or not batches:
        return None
    return sum(s["device_ms"] for s in norms) / len(batches)
