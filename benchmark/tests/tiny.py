"""Tiny specs of the benchmark's cells for CPU tests: the cells' own
traffic, a narrow encoder, a small split and short calls. The sizes are
data, one file per driver (``tiny_sizes/<driver>.json``: overrides of the
configuration and the traffic), so a new cell under an existing driver
needs no edit here, and a new driver brings its own file."""

from __future__ import annotations

import copy
import importlib
import json
from pathlib import Path

from benchmark.core import BENCH_DIR, load_spec

SIZES = Path(__file__).resolve().parent / "tiny_sizes"


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys set, nested dicts merged key by key."""
    for k, v in over.items():
        base[k] = merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return base


def driver(workload: str) -> str:
    return load_spec(workload)["traffic"]["driver"]


def kind(workload: str) -> str:
    """The cell's kind as its driver states it: ``eval`` or ``train``."""
    return importlib.import_module(f"benchmark.drivers.{driver(workload)}").Cell.kind


def tiny_spec(workload: str, **traffic) -> dict:
    """The cell at its driver's tiny size, its own limits unchanged."""
    spec = copy.deepcopy(load_spec(workload))
    sizes = json.loads((SIZES / f"{spec['traffic']['driver']}.json").read_text())
    merge(spec["config"], sizes["config"])
    merge(spec["traffic"], {**sizes["traffic"], **traffic})
    return spec


def tiny(workload: str) -> dict:
    """The cell at the tiny size, held to its ``tiny_limits`` (set from CPU
    readings of the program and of the control at that size). Where the
    card's control has no effect on the CPU (TF32), the cell's file names
    the control the CPU tests take instead (``tiny_control``)."""
    spec = tiny_spec(workload)
    cell = json.loads((BENCH_DIR / "cells" / f"{workload}.json").read_text())
    spec["limits"] = cell["tiny_limits"]
    if "tiny_control" in cell:
        spec["traffic"]["control"] = cell["tiny_control"]
    return spec
