"""Device ms per step of the program's ``train.backward`` span (the
student's backward): the median over its occurrences."""

from benchmark.metrics._program_trace import median_ms


def read(run):
    return median_ms(run, "train", "train.backward")
