"""The harness: one run of one cell.

``run(argv)`` reads ``BENCHMARK.json``, the cell's configuration and
traffic files and its limits (``cells/<workload>.json``), refuses to run
without the cards the cell asks for, builds the cell's driver
(``drivers/<traffic's driver>.py``), and then:

  1. set-up: the driver makes its inputs from the seed, builds the program
     and warms every shape the window uses; ``setup_s`` runs from the
     process's start to the window's first batch;
  2. the window: whole calls, from a synchronise until the synchronise after
     the first call that ends past ``--seconds``;
  3. with ``--trace 1``, a short profiled sub-window after it, with the
     harness's spans on;
  4. the peak memory is read, the program freed, and the reference checks
     what the window produced;
  5. the metrics named for the cell in ``BENCHMARK.json`` are read, each by
     its reader ``metrics/<name>.py``, and one JSON line is printed.

A run ends with an error and prints no result if ``sys.modules`` holds JAX,
its libraries or the JAX package once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fewshot_vit_tpu")


def process_start() -> float:
    """``time.perf_counter()`` at this process's start (Linux: from
    /proc/self/stat), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that belong to JAX or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Check:
    """One number compared with the reference, and its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Run:
    """What the metric readers read."""
    workload: str
    kind: str                       # "eval" or "train"
    unit: str                       # "episodes" or "images"
    setup_s: float
    window_s: float
    units: int
    flops_per_unit: float
    peak_flops: float
    batch_ms: List[float] = field(default_factory=list)
    trace: Optional[object] = None  # tracing.Trace of the sub-window
    spans: Dict[str, List[float]] = field(default_factory=dict)
    extra: Dict[str, object] = field(default_factory=dict)  # the cell's settings a reader needs


def load_spec(workload: str) -> dict:
    """The workload's entry with its configuration, traffic and limits."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "bench": bench,
        "workload": cell,
        "config": json.loads((ROOT / config["file"]).read_text()),
        "traffic": json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((BENCH_DIR / "cells" / f"{workload}.json").read_text())["limits"],
    }


def metrics_for(bench: dict, workload: str, section: str) -> List[dict]:
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def read_metric(name: str, run: Run) -> Optional[float]:
    """The reader ``metrics/<name>.py``'s ``read(run)``: a number, or None
    where it finds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def require_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"this cell needs {chips} CUDA device(s); found {have}: "
                         "the benchmark measures on the card only")


def make_driver(spec: dict, device, seed: int, **kw):
    """The cell's driver; ``kw`` (``control``, ``fault``) only for readings
    and tests."""
    module = importlib.import_module(f"benchmark.drivers.{spec['traffic']['driver']}")
    return module.Cell(spec, device, seed, **kw)


def measure(cell, seconds: float, sync) -> tuple:
    """The window: whole calls until one ends past ``seconds``; -> (its
    seconds, the calls, its start on ``time.perf_counter``)."""
    sync()
    t0 = time.perf_counter()
    calls = 0
    while True:
        cell.call()
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return time.perf_counter() - t0, calls, t0


def report_checks(checks: List[Check]) -> Dict[str, dict]:
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    return {c.name: {"value": c.value, "limit": c.limit} for c in checks}


def sync_for(device):
    import torch

    return (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)


def execute(spec: dict, device, seed: int, seconds: float, trace: bool,
            t_start: float, **driver_kw) -> Optional[dict]:
    """One run on ``device``: the result dict, or None where the process
    holds JAX or the JAX package after the window. ``driver_kw``
    (``control``, ``fault``) only for the tests."""
    import torch

    sync = sync_for(device)
    workload = spec["workload"]["name"]
    t_built = time.perf_counter()
    cell = make_driver(spec, device, seed, **driver_kw)
    t_warm = time.perf_counter()
    cell.warm()
    window_s, calls, t0 = measure(cell, seconds, sync)
    print(f"setup: {t_built - t_start:.2f} s to the driver, {t_warm - t_built:.2f} s inputs "
          f"and program, {t0 - t_warm:.2f} s warm", file=sys.stderr)
    run_ = Run(workload, cell.kind, cell.unit, t0 - t_start, window_s,
               calls * cell.units_per_call, cell.flops_per_unit, cell.peak_flops,
               batch_ms=cell.batch_ms(), extra=dict(cell.extra))
    if trace:
        from . import tracing

        spans = tracing.Spans(device)
        cell.install_spans(spans)
        run_.trace = tracing.profile(cell.sub_call, cell.sub_call, cell.op_names, spans, sync)
        run_.spans = spans.ms()
        spans.remove()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    cell.free()
    checks = cell.check()
    found = forbidden_modules()
    if found:
        print(f"the process holds JAX or the JAX package: {found}", file=sys.stderr)
        return None

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(spec["bench"], workload, section):
        value = read_metric(m["name"], run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": all(c.ok for c in checks), "attempted": calls * cell.attempts_per_call,
              "failed": 0, "metrics": metrics, "device": dev_info}
    if run_.trace is not None:
        dev_info["busy_s"] = run_.trace.busy_s
        dev_info["window_s"] = run_.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in run_.trace.device_ops],
                               "idle_gaps": [list(x) for x in run_.trace.idle_gaps]}
    result["checks"] = report_checks(checks)
    return result


def run(argv=None, t_start: Optional[float] = None) -> int:
    t_start = process_start() if t_start is None else t_start
    p = argparse.ArgumentParser(description="One run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = load_spec(args.workload)
    require_card(int(spec["workload"]["chips"]))
    import torch

    result = execute(spec, torch.device("cuda", 0), args.seed, args.seconds, bool(args.trace),
                     t_start)
    if result is None:
        return 3
    print(json.dumps(result))
    return 0
