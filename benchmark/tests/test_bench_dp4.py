"""The four-rank SUN training cell at its driver's tiny size on the CPU:
four gloo processes (the harness's process and the three ranks its driver
starts) run the checked steps and the window in lockstep and come out
correct, a step that leaves the state unchanged does not, nor one that
leaves out the gradient all-reduce, and a rank that ends early ends the run with an error instead of a hang.

The cell is not in ``BENCHMARK.json`` (its runs spread too widely for its
bound, ``PERF.md`` §7); ``dp4_listed`` lists it for a test, under the
configuration it shares with ``sun_train_fp32``."""

from __future__ import annotations

import json

import pytest
import torch
import torch.distributed as dist

from benchmark.core import BENCH_DIR, execute, make_driver
from benchmark.tests import tiny as tiny_module
from benchmark.tests.tiny import tiny

CPU = torch.device("cpu")
DP4 = "sun_train_dp4"
DP4_ENTRY = {"name": DP4, "config": "sun_token_label_visformer_micro_80",
             "traffic": "sun_dual_view_fp32_dp4", "chips": 4}


@pytest.fixture
def dp4_listed(monkeypatch):
    listed = tiny_module.load_spec

    def load_spec(workload):
        if workload != DP4:
            return listed(workload)
        spec = listed("sun_train_fp32")
        spec["workload"] = dict(DP4_ENTRY)
        spec["traffic"] = json.loads((BENCH_DIR / "traffic" / f"{DP4_ENTRY['traffic']}.json")
                                     .read_text())
        spec["limits"] = json.loads((BENCH_DIR / "cells" / f"{DP4}.json").read_text())["limits"]
        return spec

    monkeypatch.setattr(tiny_module, "load_spec", load_spec)


def test_tiny_dp4_run_is_correct(dp4_listed):
    out = execute(tiny(DP4), CPU, 2**31 + 11, 0.05, True, 0.0)
    assert out["correct"], out["checks"]
    assert out["checks"]["label_mismatch"]["value"] == 0
    assert not dist.is_initialized()


def test_unchanged_step_is_not_correct(dp4_listed):
    out = execute(tiny(DP4), CPU, 5, 0.05, False, 0.0, fault="unchanged")
    assert not out["correct"], out["checks"]


def test_unsynced_gradients_are_not_correct(dp4_listed):
    """Every rank steps on its own block's gradients (``no_grad_sync``)."""
    out = execute(tiny(DP4), CPU, 2**31 + 13, 0.05, False, 0.0, fault="no_grad_sync")
    assert not out["correct"], out["checks"]
    assert not dist.is_initialized()


def test_a_rank_that_ends_ends_the_run(dp4_listed):
    cell = make_driver(tiny(DP4), CPU, 7)
    try:
        cell.workers[0].kill()
        cell.workers[0].wait()
        with pytest.raises(RuntimeError, match="rank"):
            cell.call()
    finally:
        for p in cell.workers:
            p.kill()
            p.wait()
        dist.destroy_process_group()
