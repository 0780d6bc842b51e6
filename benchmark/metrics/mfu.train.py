"""Model FLOPs of every training step in the window (the student's forward
and backward and the teacher's forward, counted over the reference), over
the window's seconds times the dense TF32 peak."""

from benchmark.metrics._util import mfu_pct


def read(run):
    return mfu_pct(run, "train")
