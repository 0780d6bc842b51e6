"""Arithmetic the metric readers share."""

from __future__ import annotations

from typing import List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100) with linear interpolation between the
    closest ranks; None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def mfu_pct(run, kind: str) -> Optional[float]:
    """Model FLOPs done in the window over the window's seconds times the
    peak, in percent, for a run of ``kind``."""
    if run.kind != kind or run.window_s <= 0 or not run.flops_per_unit:
        return None
    return 100.0 * run.units * run.flops_per_unit / (run.window_s * run.peak_flops)


def idle_pct(run, kind: str) -> Optional[float]:
    """Share of the traced sub-window in which the device ran nothing."""
    if run.kind != kind or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def span_ms(run, kind: str, name: str) -> Optional[float]:
    """Mean device ms of the harness's span ``name`` per call into its layer."""
    if run.kind != kind:
        return None
    return mean(run.spans.get(name, []))
