"""Device ms per step of the frozen teacher's forward (a span on the teacher)."""

from benchmark.metrics._util import span_ms


def read(run):
    return span_ms(run, "train", "teacher")
