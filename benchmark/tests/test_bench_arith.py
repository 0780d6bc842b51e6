"""The yardstick's arithmetic: the roofline bounds equal to the repository's
kernel checks' (``chip_smoke.py``) at its phase-7 shapes, and the p95, the
idle union, the MFU and the trace reduction on synthetic numbers."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from benchmark import roofline, tracing
from benchmark.core import Run
from benchmark.metrics._util import idle_pct, mfu_pct, percentile

ROOT = Path(__file__).resolve().parents[2]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# phase 7's MHSA shapes (batch * heads folded as chip_smoke times them) and
# its Sinkhorn shapes
MHSA = [(10240, 6, 100, 42), (512, 6, 100, 42), (640, 6, 100, 42), (32, 6, 196, 128),
        (640, 6, 196, 128)]
SINKHORN = [(3000, 13, 13, 100), (3000, 25, 25, 100), (160, 13, 13, 100), (375, 13, 13, 100),
            (3000, 38, 38, 100), (3000, 196, 196, 100)]


@pytest.mark.parametrize("shape", MHSA)
def test_mhsa_bound_equals_chip_smoke(shape):
    cs = chip_smoke()
    assert roofline.bound(*shape, "bfloat16") == cs._bound(*shape, torch.bfloat16)
    assert roofline.bound(*shape, "float32") == cs._bound(*shape, torch.float32,
                                                          peak=cs.PEAK_3XTF32)


@pytest.mark.parametrize("shape", SINKHORN)
def test_sinkhorn_bound_equals_chip_smoke(shape):
    assert roofline.sinkhorn_bound(*shape) == chip_smoke()._sinkhorn_bound(*shape)


def test_peaks_equal_chip_smoke():
    cs = chip_smoke()
    assert roofline.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    assert roofline.PEAK_FLOPS["bfloat16"] == cs.PEAK_FLOPS["torch.bfloat16"]
    assert roofline.PEAK_FLOPS["float32"] == cs.PEAK_FLOPS["torch.float32"]
    assert roofline.PEAK_3XTF32 == cs.PEAK_3XTF32
    assert roofline.SFU_PER_S == cs.SFU_PER_S


def test_phase7_bound_value():
    ms, which = roofline.bound(10240, 6, 100, 42, "bfloat16")
    assert which == "bytes" and abs(ms - 0.616) < 1e-3  # PERF.md's 0.616 ms


@pytest.mark.parametrize("values,q,want", [
    ([5.0], 95, 5.0), (list(range(1, 101)), 95, 95.05), ([1.0, 2.0], 50, 1.5),
    (list(range(21)), 95, 19.0), ([], 95, None)])
def test_percentile(values, q, want):
    got = percentile(values, q)
    assert got == want if want is None else abs(got - want) < 1e-9


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 12.0)]
    assert tracing.union_length(iv, 0.0, 10.0) == 3.0 + 1.0 + 1.0
    assert tracing.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert tracing.union_length([], 0.0, 1.0) == 0.0


def test_mfu_and_idle():
    run = Run("w", "eval", "episodes", 1.0, window_s=2.0, units=100, flops_per_unit=1e12,
              peak_flops=1e15)
    assert abs(mfu_pct(run, "eval") - 5.0) < 1e-12
    assert mfu_pct(run, "train") is None
    run.trace = tracing.Trace(window_s=0.5, busy_s=0.4)
    assert abs(idle_pct(run, "eval") - 20.0) < 1e-9


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": 1, "pid": 1,
            "args": args}


def test_reduce_trace_links_kernels_to_op_calls():
    op = "fewshot_vit_tpu_torch::fused_mhsa"
    events = [
        _x(tracing.SUBWINDOW, "user_annotation", 100, 1000),
        _x(op, "cpu_op", 150, 20, **{"Input Dims": [[64, 6, 100, 42]] * 3,
                                     "Input type": ["c10::BFloat16"] * 3}),
        _x("cudaLaunchKernel", "cuda_runtime", 160, 5, correlation=7),
        _x("mhsa_tc_kernel", "kernel", 300, 40, correlation=7),
        _x("gemm", "kernel", 200, 100, correlation=8),
        _x("Memcpy HtoD", "gpu_memcpy", 320, 30, correlation=9),
        _x("outside", "kernel", 50, 10, correlation=10),
    ]
    t = tracing.reduce_trace(events, (op,))
    assert abs(t.window_s - 1e-3) < 1e-12
    assert abs(t.busy_s - 150e-6) < 1e-12          # [200, 350)
    assert len(t.op_calls) == 1 and abs(t.op_calls[0].device_s - 40e-6) < 1e-12
    assert t.op_calls[0].dims[0] == [64, 6, 100, 42]
    assert t.device_ops[0][0] == "gemm" and t.device_ops[0][1] == pytest.approx(100e-6)
    assert max(d for _, d in t.idle_gaps) == pytest.approx(750e-6)


def test_reduce_trace_refuses_an_uncorrelated_call():
    """On a device trace every op call launches; a call whose kernels no
    correlation id names is an error, never a guess by kernel name."""
    op = "fewshot_vit_tpu_torch::sinkhorn_pallas"
    events = [
        _x(tracing.SUBWINDOW, "user_annotation", 100, 1000),
        _x(op, "cpu_op", 150, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 160, 5),
        _x("sinkhorn_packed_kernel", "kernel", 300, 40),
    ]
    with pytest.raises(RuntimeError, match="correlated"):
        tracing.reduce_trace(events, (op,))
    # a CPU run: the op took its plain version and launched nothing
    cpu = [e for e in events if e["cat"] != "kernel"]
    assert tracing.reduce_trace(cpu, (op,)).op_calls == []


def test_roofline_readers_sum_over_calls():
    spec = importlib.util.spec_from_file_location(
        "mhsa_reader", ROOT / "benchmark" / "metrics" / "mhsa_roofline_pct.eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    least = roofline.bound(64, 6, 100, 42, "bfloat16")[0] * 1e-3
    calls = [tracing.OpCall("fewshot_vit_tpu_torch::fused_mhsa", [[64, 6, 100, 42]] * 3,
                            ["c10::BFloat16"] * 3, 2 * least)] * 3
    run = Run("w", "eval", "episodes", 1.0, 1.0, 1, 1.0, 1.0,
              trace=tracing.Trace(1.0, 1.0, calls))
    assert abs(mod.read(run) - 50.0) < 1e-9
    run.trace = tracing.Trace(1.0, 1.0, [])
    assert mod.read(run) is None


def test_sinkhorn_roofline_takes_the_calls_iterations():
    """The bound counts the iterations each call asked for, so a call that
    asks for fewer does not read as nearer its roofline."""
    spec = importlib.util.spec_from_file_location(
        "sinkhorn_reader", ROOT / "benchmark" / "metrics" / "sinkhorn_roofline_pct.eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    op = "fewshot_vit_tpu_torch::sinkhorn_pallas"
    least = roofline.sinkhorn_bound(1500, 13, 13, 25)[0] * 1e-3
    call = tracing.OpCall(op, [[1500, 13, 13], [1500, 13], [1500, 13], [], [], []],
                          ["float"] * 3, 4 * least, ["", "", "", "0.05", "25", ""])
    run = Run("w", "eval", "episodes", 1.0, 1.0, 1, 1.0, 1.0,
              trace=tracing.Trace(1.0, 1.0, [call]), extra={"solver_iters": 100})
    assert abs(mod.read(run) - 25.0) < 1e-9
    call.concrete = []  # not recorded: the configured iterations
    full = roofline.sinkhorn_bound(1500, 13, 13, 100)[0] * 1e-3
    assert abs(mod.read(run) - 100.0 * full / (4 * least)) < 1e-9
