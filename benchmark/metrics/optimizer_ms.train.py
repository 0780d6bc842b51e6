"""Device ms per step of the program's ``train.optimizer`` span (AdamW's
step): the median over its occurrences."""

from benchmark.metrics._program_trace import median_ms


def read(run):
    return median_ms(run, "train", "train.optimizer")
