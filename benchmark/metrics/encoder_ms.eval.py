"""Device ms per batch of the encoder's forward (a span on ``head.encoder``)."""

from benchmark.metrics._util import span_ms


def read(run):
    return span_ms(run, "eval", "encoder")
