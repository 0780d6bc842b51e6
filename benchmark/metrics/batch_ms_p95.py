"""The 95th percentile, over every batch of the window, of the device ms
from the end of one batch's head to the end of the next (the first batch of
a call from an event recorded before the call)."""

from benchmark.metrics._util import percentile


def read(run):
    return percentile(run.batch_ms, 95.0)
