"""The readers of the program's own spans and counters: in a tiny traced
run on the CPU of every cell a metric names, the metric reads a number
(off the card a span's device ms are its host ms, and no synchronisation is
counted); untraced runs and a program without the registry give none."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

from benchmark.core import Run, execute, read_metric
from benchmark.tests.tiny import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = {"inputs_ms.eval", "student_ms.train", "backward_ms.train", "optimizer_ms.train",
         "host_syncs.eval", "host_syncs.train"}
PROGRAM = [m for m in BENCH["per_layer"] if m["name"] in NAMES]
CELLS = sorted({w for m in PROGRAM for w in m["workloads"]})
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_registry():
    from fewshot_vit_tpu_torch.core import trace

    trace.reset()
    yield
    trace.reset()


def test_the_readers_are_listed():
    assert {m["name"] for m in PROGRAM} == NAMES
    for m in PROGRAM:
        assert m["source"] == ("program_counter" if m["name"].startswith("host_syncs")
                               else "program_span")


@pytest.mark.parametrize("workload", CELLS)
def test_traced_tiny_run_reads_every_program_metric(workload):
    out = execute(tiny(workload), CPU, 2**31 + 19, 0.05, True, 0.0)
    assert out["correct"], out["checks"]
    for m in PROGRAM:
        if workload not in m["workloads"]:
            assert m["name"] not in out["metrics"]
            continue
        got = out["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and isinstance(got["value"], float), (m["name"], got)
        if m["source"] == "program_span":
            assert got["value"] > 0, m["name"]
        else:
            assert got["value"] == 0.0, m["name"]  # the CPU counts no synchronisation


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run_records_no_span(workload):
    from fewshot_vit_tpu_torch.core import trace

    out = execute(tiny(workload), CPU, 2**31 + 19, 0.05, False, 0.0)
    assert not any(m["name"] in out["metrics"] for m in PROGRAM)
    assert trace.snapshot()["spans"] == {}


def test_a_program_without_the_registry_gives_nothing(monkeypatch):
    """A program with no ``core.trace`` (this change's parent): the readers
    return None rather than raise, where the registry itself would give
    numbers."""
    import fewshot_vit_tpu_torch.core as core
    from fewshot_vit_tpu_torch.core import trace

    trace.enable()
    for name in ("eval.batch", "eval.inputs", "train.step", "train.student", "train.backward",
                 "train.optimizer"):
        with trace.span(name):
            pass
    trace.disable()
    runs = {k: Run("w", k, "u", 1.0, 1.0, 1, 1.0, 1.0, trace=object()) for k in ("eval", "train")}
    kinds = {m["name"]: m["name"].rsplit(".", 1)[1] for m in PROGRAM}
    assert all(read_metric(n, runs[k]) is not None for n, k in kinds.items())
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "fewshot_vit_tpu_torch.core.trace", None)
    for name, kind in kinds.items():
        assert read_metric(name, runs[kind]) is None, name
