"""The harness: its refusal without a card, the contract of
``BENCHMARK.json`` and the files it names, whole runs of every cell at a
tiny size on the CPU, the controls at that size, and a run broken underneath
(a step that leaves its state unchanged, half of a batch left out, an answer
or a label altered where it is produced) that must come out not correct."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.core import execute, load_spec
from benchmark.readings import readings
from benchmark.tests.tiny import kind, tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
EVAL_CELLS = [w["name"] for w in BENCH["workloads"] if kind(w["name"]) == "eval"]
TRAIN_CELLS = [w["name"] for w in BENCH["workloads"] if kind(w["name"]) == "train"]


def fails(numbers, limits):
    """True where some number is over its limit, the exact ones held to 0."""
    held = {**limits, "acc_outside": 0.0, "label_mismatch": 0.0}
    return any(numbers[k] > v for k, v in held.items() if k in numbers)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sunm_eval_bench",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA device" in p.stderr


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"] and BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and len(c["source"]) <= 200 and len(c["why"]) <= 200
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/") and cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] and all(k in cfg for k in c["reduced"])
    used = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        used.add(w["config"])
        spec = load_spec(w["name"])
        assert (ROOT / "benchmark" / "drivers" / f"{spec['traffic']['driver']}.py").exists()
        assert spec["limits"]
    assert used == set(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert set(m.get("workloads", cells)) <= cells
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
            if section == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
            else:
                assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in cells:
        mine = [m for m in BENCH["per_layer"] if w in m.get("workloads", cells)]
        assert mine and any(w in m.get("workloads", cells) and m["name"] != "setup_s"
                            for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", EVAL_CELLS + TRAIN_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(workload, trace):
    out = execute(tiny(workload), CPU, 2**31 + 11, 0.05, trace, 0.0)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["metrics"]


@pytest.mark.parametrize("workload", EVAL_CELLS + TRAIN_CELLS)
def test_control_is_not_correct(workload):
    spec = tiny(workload)
    for _, numbers in readings(spec, CPU, [5, 6, 2**32 + 3], control=True):
        assert fails(numbers, spec["limits"]), numbers


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "token"])
@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_broken_training_step_is_not_correct(workload, fault):
    for seed in (5, 2**32 + 3):
        out = execute(tiny(workload), CPU, seed, 0.05, False, 0.0, fault=fault)
        assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", EVAL_CELLS)
def test_altered_answer_is_not_correct(workload, monkeypatch):
    from fewshot_vit_tpu_torch.heads import deepemd, meta_baseline

    def altered(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k).clone()
            out[..., 0, 0] += 1.0
            return out
        return wrapped

    monkeypatch.setattr(meta_baseline, "compute_logits", altered(meta_baseline.compute_logits))
    monkeypatch.setattr(deepemd, "emd_distance", altered(deepemd.emd_distance))
    out = execute(tiny(workload), CPU, 2**31 + 13, 0.05, False, 0.0)
    assert not out["correct"], out["checks"]


EMD_CELLS = [w for w in EVAL_CELLS if load_spec(w)["traffic"]["driver"] == "emd_eval"]


@pytest.mark.parametrize("workload", EMD_CELLS)
def test_short_solver_is_not_correct(workload):
    """The solver stopped at a quarter of its iterations. Seeds whose tiny
    random encoder gives near-uniform similarities (seed 5: a range of 0.2)
    converge in under ten iterations at this size and cannot show it."""
    for seed in (6, 2**32 + 3):
        out = execute(tiny(workload), CPU, seed, 0.05, False, 0.0, fault="iters_25")
        assert not out["correct"], out["checks"]
        assert out["checks"]["flow_rel"]["value"] > out["checks"]["flow_rel"]["limit"]


@pytest.mark.parametrize("workload", EVAL_CELLS)
def test_unnamed_route_is_not_correct(workload, monkeypatch):
    """A kernel route that the traffic does not name launches in the window."""
    from benchmark.drivers import common

    counts = {"fused_mhsa.general": 0}

    def launches():
        counts["fused_mhsa.general"] += 1
        return dict(counts)

    monkeypatch.setattr(common, "launch_counts", launches)
    out = execute(tiny(workload), CPU, 2**31 + 13, 0.05, False, 0.0)
    assert not out["correct"] and out["checks"]["route_off"]["value"] > 0, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", EVAL_CELLS + TRAIN_CELLS)
def test_tiny_run_on_the_card(workload):
    """The whole traced run on the card at the tiny size. Its limits are the
    CPU's (the card's TF32 reads higher at this size), so correctness is
    judged by the cells' own runs at their full sizes, not here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = execute(tiny(workload), torch.device("cuda", 0), 2**31 + 17, 0.2, True, 0.0)
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert out["metrics"] and list(out)[-1] == "checks"
    assert out["checks"]["acc_outside" if workload in EVAL_CELLS else "label_mismatch"][
        "value"] == 0
