"""Share of the traced sub-window in which no kernel, copy or memset ran."""

from benchmark.metrics._util import idle_pct


def read(run):
    return idle_pct(run, "train")
