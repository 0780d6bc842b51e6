"""Device ms per step of the program's ``train.student`` span (the
student's forward and its loss): the median over its occurrences."""

from benchmark.metrics._program_trace import median_ms


def read(run):
    return median_ms(run, "train", "train.student")
