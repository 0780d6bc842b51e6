"""What the readers of the program's own spans and counters share.

The program keeps them in its registry (``fewshot_vit_tpu_torch.core.trace``),
recording while a profiler session is on: in a traced run, the warm call and
the sub-window, which run the same batches. The readers run in the same
process after the sub-window. A program without the registry gives nothing,
and its readers return None."""

from __future__ import annotations

import statistics
from typing import Optional


def _spans(run, kind: str, name: str) -> list:
    if run.kind != kind or run.trace is None:
        return []
    try:
        from fewshot_vit_tpu_torch.core import trace
    except ImportError:
        return []
    return trace.snapshot()["spans"].get(name, [])


def median_ms(run, kind: str, name: str) -> Optional[float]:
    """Median device ms of the program's span ``name`` over its occurrences."""
    spans = _spans(run, kind, name)
    return statistics.median(s["device_ms"] for s in spans) if spans else None


def per_occurrence(run, kind: str, counter: str, name: str) -> Optional[float]:
    """The program's counter ``counter`` under its span ``name`` (the spans
    inside it included), summed over the span's occurrences, over their
    number."""
    spans = _spans(run, kind, name)
    return sum(s["counts"].get(counter, 0) for s in spans) / len(spans) if spans else None
