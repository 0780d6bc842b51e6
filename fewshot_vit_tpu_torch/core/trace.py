"""Spans and counters at the port's layer boundaries.

One registry per process. ``span(name)`` marks a stretch of the program (a
context manager, also a decorator); ``count(name, n)`` adds to a counter;
``snapshot()`` reads both, ``reset()`` reads and clears them.

Tracing is on while a ``torch.profiler`` session records, or after
``enable()``. With tracing off a span makes one check and nothing else: no
``record_function``, no event, nothing kept. Under ``torch.compile`` and
``torch.export`` a span does nothing, so traced graphs never hold one. With
tracing on a span

  * enters ``torch.profiler.record_function(name)``: a ``user_annotation``
    in the profiler's trace, on the kernels' clock;
  * takes ``time.perf_counter_ns`` at entry and exit;
  * records a pair of CUDA timing events on the current stream (host time
    where CUDA is not initialised);
  * keeps its parent, the span open when it began; up to ``CAP`` spans a
    name are kept.

A span opened with ``opaque=True`` (one around a loop) keeps every span
opened inside it from recording.

Counters. ``count`` adds to a process-wide total and to the innermost open
span; a span's counts include those of the spans inside it. The counters
that live as attributes of their own modules (``ATTRIBUTE_COUNTERS``: the
kernels' ``route_launches``, ``window_attention.launches``,
``layer_norm.launches`` and ``block_attention.launches``,
``exact_flows.host_seconds``) are read where
they live, once their modules are imported, so ``snapshot()["counters"]``
holds every counter of the port. They count with tracing off, their owners
set them back to 0, and ``reset`` leaves them alone. (The kernels' modules
do not import this one: an exported program loads them alone.)

Host synchronisations. While the outermost span is open with tracing on,
``torch.cuda.set_sync_debug_mode("warn")`` is set (where CUDA is
initialised), and each warning it raises ("called a synchronizing CUDA
operation": a blocking copy, ``.item()``, ``.cpu()``, ``nonzero``) becomes
one count of ``host_syncs`` instead of a printed warning. The mode, the
warning filters and ``warnings.showwarning`` are restored when that span
closes. ``torch.cuda.synchronize()`` raises no such warning and is not
counted.

The registry is meant for one thread at a time: spans opened in the
autograd engine's thread (a checkpointed forward's recomputation, while the
caller waits in ``backward``) nest under the caller's open span.
"""

from __future__ import annotations

import functools
import sys
import time
import warnings
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

CAP = 4096  # spans kept a name
SYNC_COUNTER = "host_syncs"
_SYNC_MESSAGE = "called a synchronizing CUDA operation"
# name -> (module, object in it, the object's attribute holding the count)
ATTRIBUTE_COUNTERS = {
    "fused_mhsa.route_launches": ("fewshot_vit_tpu_torch.kernels.attention", "fused_mhsa",
                                  "route_launches"),
    "sinkhorn_pallas.route_launches": ("fewshot_vit_tpu_torch.kernels.sinkhorn",
                                       "sinkhorn_pallas", "route_launches"),
    "exact_flows.host_seconds": ("fewshot_vit_tpu_torch.heads.deepemd", "exact_flows",
                                 "host_seconds"),
    "window_attention.launches": ("fewshot_vit_tpu_torch.kernels.window",
                                  "window_attention", "launches"),
    "layer_norm.launches": ("fewshot_vit_tpu_torch.kernels.layer_norm", "layer_norm", "launches"),
    "block_attention.launches": ("fewshot_vit_tpu_torch.kernels.block", "block_attention",
                                 "launches"),
}


class _HostEvent:
    """A timing event on the host clock, where CUDA is not initialised."""

    __slots__ = ("t",)

    def record(self) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


class _Record:
    __slots__ = ("name", "index", "parent", "opaque", "rf", "t0", "t1", "ev0", "ev1", "ms",
                 "counts")

    def __init__(self, name: str, index: int, parent: Optional["_Record"], opaque: bool):
        self.name, self.index, self.opaque = name, index, opaque
        self.parent = (parent.name, parent.index) if parent is not None else None
        self.counts: Dict[str, float] = {}
        self.ms: Optional[float] = None

    def device_ms(self) -> float:
        if self.ms is None:
            self.ev1.synchronize()
            self.ms = self.ev0.elapsed_time(self.ev1)
        return self.ms

    def as_dict(self) -> dict:
        return {"index": self.index,
                "parent": self.parent[0] if self.parent else None,
                "parent_index": self.parent[1] if self.parent else None,
                "start_ns": self.t0, "end_ns": self.t1, "host_ms": (self.t1 - self.t0) * 1e-6,
                "device_ms": self.device_ms(), "counts": dict(self.counts)}


class _Registry:
    def __init__(self):
        self.enabled = False
        self.stack: List[_Record] = []
        self.records: Dict[str, List[_Record]] = {}
        self.seen: Dict[str, int] = {}
        self.totals: Dict[str, float] = {}
        self._sync = None  # (sync debug mode to restore or None, catch_warnings)

    # --- spans ----------------------------------------------------------------
    def open(self, name: str, opaque: bool) -> Optional[_Record]:
        parent = self.stack[-1] if self.stack else None
        if parent is not None and parent.opaque:
            return None
        index = self.seen.get(name, 0)
        self.seen[name] = index + 1
        rec = _Record(name, index, parent, opaque)
        if parent is None:
            self._count_syncs()
        rec.rf = record_function(name)
        rec.rf.__enter__()
        rec.t0 = time.perf_counter_ns()
        rec.ev0, rec.ev1 = (_cuda_event(), _cuda_event()) if torch.cuda.is_initialized() \
            else (_HostEvent(), _HostEvent())
        rec.ev0.record()
        self.stack.append(rec)
        return rec

    def close(self, rec: _Record) -> None:
        rec.ev1.record()
        rec.t1 = time.perf_counter_ns()
        rec.rf.__exit__(None, None, None)
        rec.rf = None
        self.stack.pop()  # spans are context managers: the last opened closes first
        if self.stack:
            into = self.stack[-1].counts
            for k, v in rec.counts.items():
                into[k] = into.get(k, 0) + v
        kept = self.records.setdefault(rec.name, [])
        if len(kept) < CAP:
            kept.append(rec)
        if not self.stack:
            self._stop_counting_syncs()

    # --- host synchronisations --------------------------------------------------
    def _count_syncs(self) -> None:
        if self._sync is not None:
            return
        mode = None
        if torch.cuda.is_initialized():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        filters = warnings.catch_warnings()
        filters.__enter__()
        shown = warnings.showwarning

        def on_warning(message, category, filename, lineno, file=None, line=None):
            if _SYNC_MESSAGE in str(message):
                count(SYNC_COUNTER)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.filterwarnings("always", message=f".*{_SYNC_MESSAGE}")
        warnings.showwarning = on_warning
        self._sync = (mode, filters)

    def _stop_counting_syncs(self) -> None:
        if self._sync is None:
            return
        mode, filters = self._sync
        self._sync = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        filters.__exit__(None, None, None)


_R = _Registry()


def _cuda_event():
    return torch.cuda.Event(enable_timing=True)


def enable() -> None:
    """Trace without a profiler session, until ``disable()``."""
    _R.enabled = True


def disable() -> None:
    _R.enabled = False


class span:
    """``with span(name):`` or ``@span(name)``: a named stretch of the
    program, recorded while tracing is on (module docstring)."""

    __slots__ = ("name", "opaque", "_rec")

    def __init__(self, name: str, opaque: bool = False):
        self.name = name
        self.opaque = opaque

    def __enter__(self) -> "span":
        if torch.compiler.is_compiling() or not (_R.enabled or _profiler_enabled()):
            self._rec = None
        else:
            self._rec = _R.open(self.name, self.opaque)
        return self

    def __exit__(self, *exc) -> bool:
        if self._rec is not None:
            _R.close(self._rec)
            self._rec = None
        return False

    def __call__(self, fn: Callable) -> Callable:
        name, opaque = self.name, self.opaque

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, opaque):
                return fn(*args, **kwargs)

        return spanned


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``: to its process-wide total and, if a
    span is open, to the innermost one."""
    _R.totals[name] = _R.totals.get(name, 0) + n
    if _R.stack:
        counts = _R.stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def counters() -> Dict[str, float]:
    """Every counter: the totals of ``count``, and the ``ATTRIBUTE_COUNTERS``
    of the modules imported so far (a dict of counts as ``<name>.<key>``)."""
    out = dict(_R.totals)
    for name, (module, obj, attr) in ATTRIBUTE_COUNTERS.items():
        if module not in sys.modules:
            continue
        value = getattr(getattr(sys.modules[module], obj), attr)
        if isinstance(value, dict):
            out.update({f"{name}.{k}": v for k, v in value.items()})
        else:
            out[name] = value
    return out


def snapshot() -> dict:
    """``{"spans": {name: [one dict a closed span: index, parent,
    parent_index, start_ns, end_ns, host_ms, device_ms, counts]},
    "counters": counters(), "dropped": {name: spans past CAP}}``. Reading a
    span's device ms waits for its end event."""
    return {"spans": {name: [r.as_dict() for r in recs] for name, recs in _R.records.items()},
            "counters": counters(),
            "dropped": {name: n - len(_R.records.get(name, ())) for name, n in _R.seen.items()
                        if n > len(_R.records.get(name, ()))}}


def reset() -> dict:
    """``snapshot()``, then forget every closed span and the totals of
    ``count``."""
    out = snapshot()
    _R.records.clear()
    _R.seen.clear()
    _R.totals.clear()
    return out
