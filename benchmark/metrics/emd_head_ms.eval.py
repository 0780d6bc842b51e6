"""Device ms per batch of the DeepEMD matching (a span on ``head.meta``:
weights, similarity, Sinkhorn, logits), the head's time beside the
encoder's."""

from benchmark.metrics._util import span_ms


def read(run):
    return span_ms(run, "eval", "emd_head")
