"""The traced sub-window: spans recorded by the harness around calls into the
program's layers, and the reduction of a ``torch.profiler`` trace to device
busy time, kernel time per op call, the device's top operations and its
longest idle gaps.

Spans are pairs of CUDA events at a module's forward pre- and post-hook, or
around a callable the harness hands the program; a span's time is the
device's time between its two events. The profiler records CPU and CUDA
activity in memory; its Chrome trace is read once and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
SUBWINDOW = "benchmark.subwindow"


class HostEvent:
    """A stand-in for a CUDA event on the CPU (tests only): host time."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, other: "HostEvent") -> float:
        return (other.t - self.t) * 1e3


def event(device):
    """A timing event on ``device``'s stream (a ``HostEvent`` off the card)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return HostEvent()


class Spans:
    """Named device-time spans; recording only while ``on``."""

    def __init__(self, device="cuda"):
        self.device = device
        self.on = False
        self.events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = {}
        self._open: Dict[str, torch.cuda.Event] = {}
        self._hooks = []

    def _begin(self, name: str) -> None:
        if self.on:
            ev = event(self.device)
            ev.record()
            self._open[name] = ev

    def _end(self, name: str) -> None:
        if self.on and name in self._open:
            ev = event(self.device)
            ev.record()
            self.events.setdefault(name, []).append((self._open.pop(name), ev))

    def module(self, name: str, module: torch.nn.Module) -> None:
        """A span around every forward of ``module``."""
        self._hooks.append(module.register_forward_pre_hook(lambda *_: self._begin(name)))
        self._hooks.append(module.register_forward_hook(lambda *_: self._end(name)))

    def wrap(self, name: str, fn: Callable) -> Callable:
        """``fn`` with a span around every call."""

        def wrapped(*args, **kwargs):
            self._begin(name)
            out = fn(*args, **kwargs)
            self._end(name)
            return out

        return wrapped

    def ms(self) -> Dict[str, List[float]]:
        """Device ms of every closed span, by name (after a synchronise)."""
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.events.items()}

    def remove(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


@dataclass
class OpCall:
    name: str
    dims: list
    types: list
    device_s: float
    concrete: list = field(default_factory=list)  # the scalar arguments, as recorded


@dataclass
class Trace:
    window_s: float
    busy_s: float
    op_calls: List[OpCall] = field(default_factory=list)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def union_length(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle (start, end) stretches of [lo, hi] outside every interval."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def reduce_trace(events: List[dict], op_names: Tuple[str, ...]) -> Trace:
    """Reduce Chrome-trace events (times in us) to a ``Trace``: the window is
    the ``SUBWINDOW`` annotation; busy time is the union of device
    intervals inside it; each CPU op named in ``op_names`` gets the device
    time of the kernels whose launches lie inside it on its thread (by
    correlation id). In a trace with device activity, a call with no kernel
    correlated to it is an error: its kernels' time would otherwise be
    guessed."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == SUBWINDOW and not str(e.get("cat", "")).startswith("gpu")]
    if not win:
        raise RuntimeError("the trace has no sub-window annotation")
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATEGORIES and lo <= e["ts"] <= hi]
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    busy = union_length(intervals, lo, hi)

    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    cpu_ops = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation", "python_function")
               and lo <= e["ts"] <= hi and e.get("name") != SUBWINDOW]
    idle = []
    for s, e in sorted(gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (s + e)
        inside = [c for c in cpu_ops if c["ts"] <= mid <= c["ts"] + c["dur"]]
        label = max(inside, key=lambda c: c["ts"])["name"] if inside else "host: outside any op"
        idle.append((label, (e - s) * 1e-6))

    kernels_by_corr = {}
    for e in dev:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            kernels_by_corr.setdefault(corr, []).append(e)
    launches = [e for e in xs if e.get("cat") in LAUNCH_CATEGORIES]
    op_calls = []
    for op in op_names:
        calls = sorted((e for e in xs if e.get("cat") == "cpu_op" and e.get("name") == op
                        and lo <= e["ts"] <= hi), key=lambda e: e["ts"])
        if not calls:
            continue
        for c in calls:
            inside = [ln for ln in launches if ln.get("tid") == c.get("tid")
                      and c["ts"] <= ln["ts"] <= c["ts"] + c["dur"]]
            ks = [k for ln in inside for k in kernels_by_corr.get(
                ln.get("args", {}).get("correlation"), [])]
            if not ks:
                if dev:  # on a device trace every call launches: fail, never guess
                    raise RuntimeError(f"no kernel in the trace is correlated to the {op} "
                                       f"call at {c['ts']} us")
                continue  # a CPU run: the op took its plain version
            args = c.get("args", {})
            op_calls.append(OpCall(op, args.get("Input Dims", []), args.get("Input type", []),
                                   sum(k["dur"] for k in ks) * 1e-6,
                                   args.get("Concrete Inputs", [])))
    return Trace((hi - lo) * 1e-6, busy * 1e-6, op_calls,
                 [(n, d * 1e-6) for n, d in device_ops], idle)


def profile(fn: Callable[[], None], warm: Callable[[], None], op_names: Tuple[str, ...],
            spans: Optional[Spans] = None,
            sync: Callable[[], None] = torch.cuda.synchronize) -> Trace:
    """Run ``warm()`` then ``fn()`` under the profiler, ``fn`` inside the
    sub-window annotation (synchronised at both edges) with ``spans`` on,
    and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # shapes only where an op call is read: recording them costs host time
    with torch_profile(activities=acts, record_shapes=bool(op_names)) as prof:
        warm()
        sync()
        if spans is not None:
            spans.on = True
        with record_function(SUBWINDOW):
            fn()
            sync()
        if spans is not None:
            spans.on = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_trace(events, op_names)
