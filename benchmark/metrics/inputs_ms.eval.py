"""Device ms per batch of the program's ``eval.inputs`` span (the gather,
normalize and, in SUN-D, the grid patches): the median over its
occurrences."""

from benchmark.metrics._program_trace import median_ms


def read(run):
    return median_ms(run, "eval", "eval.inputs")
