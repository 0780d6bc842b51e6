"""Device ms per step of the dual-view augmentation (a span around the
function the harness hands the step)."""

from benchmark.metrics._util import span_ms


def read(run):
    return span_ms(run, "train", "augment")
