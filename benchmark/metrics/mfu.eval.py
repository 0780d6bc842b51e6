"""Model FLOPs (the reference's, counted once at the cell's shapes) of every
episode scored in the window, over the window's seconds times the peak:
bf16 dense for a bf16 cell, dense TF32 for an fp32 one."""

from benchmark.metrics._util import mfu_pct


def read(run):
    return mfu_pct(run, "eval")
