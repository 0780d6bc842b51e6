"""The Swin-T cell and the 5-shot SFC cell at their drivers' tiny sizes on
the CPU: each fault breaks the check, the window-attention readers read a
traced run and nothing from a program without the spans, a program without
the Swin-T encoder stops before the split is made, the window roofline's
arithmetic, and the reference SFC against the program's.

The SFC cell is not in ``BENCHMARK.json`` yet (its host-bound batches
spread too widely for its bound); ``sfc_listed`` lists it for a test, under
the configuration it shares with ``sund_eval_grid_1shot``."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from benchmark import inputs
from benchmark.core import BENCH_DIR, Run, execute, read_metric
from benchmark.readings import readings
from benchmark.roofline import HBM_BYTES_PER_S, PEAK_FLOPS
from benchmark.roofline_window import window_attention_bound, windows_per_image
from benchmark.tests import tiny as tiny_module
from benchmark.tests.test_bench_harness import fails
from benchmark.tests.tiny import tiny

CPU = torch.device("cpu")
SWIN, SFC = "sunm_eval_swin_tiny_224", "sund_eval_grid_5shot_sfc"
SFC_ENTRY = {"name": SFC, "config": "sund_grid_visformer_micro_80",
             "traffic": "emd_grid_5shot_sfc_bf16", "chips": 1}
SWIN_T = dict(img_size=224, patch_size=4, window_size=7, embed_dim=96, depths=(2, 2, 6, 2),
              num_heads=(3, 6, 12, 24))
WINDOW_METRICS = ("window_attn_ms.eval", "window_attn_roofline_pct.eval")


@pytest.fixture
def sfc_listed(monkeypatch):
    listed = tiny_module.load_spec

    def load_spec(workload):
        if workload != SFC:
            return listed(workload)
        spec = listed("sund_eval_grid_1shot")
        spec["workload"] = dict(SFC_ENTRY)
        spec["traffic"] = json.loads((BENCH_DIR / "traffic" / f"{SFC_ENTRY['traffic']}.json")
                                     .read_text())
        spec["limits"] = json.loads((BENCH_DIR / "cells" / f"{SFC}.json").read_text())["limits"]
        return spec

    monkeypatch.setattr(tiny_module, "load_spec", load_spec)


@pytest.mark.parametrize("workload,fault", [(SWIN, "no_shift"), (SWIN, "no_rel_bias"),
                                            (SFC, "sfc_half_steps")])
def test_fault_is_not_correct(workload, fault, sfc_listed):
    for seed in (5, 2**32 + 3):
        out = execute(tiny(workload), CPU, seed, 0.05, False, 0.0, fault=fault)
        assert not out["correct"], out["checks"]


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_sfc_run_is_correct(trace, sfc_listed):
    out = execute(tiny(SFC), CPU, 2**31 + 11, 0.05, trace, 0.0)
    assert out["correct"], out["checks"]


def test_sfc_control_is_not_correct(sfc_listed):
    spec = tiny(SFC)
    for _, numbers in readings(spec, CPU, [5, 6, 2**32 + 3], control=True):
        assert fails(numbers, spec["limits"]), numbers


def test_traced_swin_run_reads_the_window_attention():
    out = execute(tiny(SWIN), CPU, 2**31 + 23, 0.05, True, 0.0)
    assert out["correct"], out["checks"]
    assert out["metrics"]["window_attn_ms.eval"]["value"] > 0
    assert 0 < out["metrics"]["window_attn_roofline_pct.eval"]["value"] <= 100


def test_window_readers_give_nothing_without_the_spans(monkeypatch):
    """A traced run of a Visformer cell, and a program without the
    registry (an older parent): the readers return None."""
    out = execute(tiny("sunm_eval_bench"), CPU, 2**31 + 23, 0.05, True, 0.0)
    assert not set(WINDOW_METRICS) & set(out["metrics"])
    import fewshot_vit_tpu_torch.core as core

    run = Run("w", "eval", "episodes", 1.0, 1.0, 1, 1.0, 1.0, trace=object(),
              extra={"encoder_args": SWIN_T, "dtype": "bfloat16"})
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "fewshot_vit_tpu_torch.core.trace", None)
    assert all(read_metric(name, run) is None for name in WINDOW_METRICS)


def test_a_program_without_the_encoder_stops_before_the_split(monkeypatch):
    import fewshot_vit_tpu_torch.models  # noqa: F401  (fills the registry)
    from fewshot_vit_tpu_torch.core.registry import models

    monkeypatch.delitem(models._ctors, "swin_tiny_patch4_window7_224")
    made = []
    monkeypatch.setattr(inputs, "split", lambda *a, **k: made.append(a))
    with pytest.raises(KeyError, match="swin_tiny_patch4_window7_224"):
        execute(tiny(SWIN), CPU, 7, 0.05, False, 0.0)
    assert made == []


def test_window_roofline_counts_the_spans_work():
    """Swin-T at 224 px: 186 windows an image. A block's span reads its
    input and writes its output, 49 tokens by C channels a window in bf16,
    and does 8 n C^2 + 4 n^2 C flops a window; stage 1 (C = 96, 241 flops a
    byte) is bound by its bytes, the later stages by their flops. The
    weights, read once a forward, add a few MB."""
    assert windows_per_image(SWIN_T) == 64 * 2 + 16 * 2 + 4 * 6 + 1 * 2 == 186
    images = 2560
    want = 0.0
    for windows, c, depth, heads in ((64, 96, 2, 3), (16, 192, 2, 6), (4, 384, 6, 12),
                                     (1, 768, 2, 24)):
        act = images * windows * 2 * 49 * c * 2
        weights = (4 * c * c + 3 * c + c + 13 * 13 * heads) * 2
        flops = images * windows * (8 * 49 * c * c + 4 * 49 * 49 * c)
        by_bytes = (act + weights) / HBM_BYTES_PER_S
        by_flops = flops / PEAK_FLOPS["bfloat16"]
        assert (by_bytes > by_flops) == (c == 96)
        want += depth * max(by_bytes, by_flops)
    got = window_attention_bound(SWIN_T, 186 * images, 1, "bfloat16")
    assert got == pytest.approx(want * 1e3, rel=1e-12)
    assert 8.2 < got < 8.3
    assert window_attention_bound(SWIN_T, 186 * images, 4, "bfloat16") > got


def test_reference_sfc_matches_the_program():
    """fp32 on both sides, the same nodes and shuffle orders: the program's
    autograd SFC and the reference's agree to fp32 rounding after 10 steps
    at lr 100."""
    from benchmark.reference.heads import emd_logits
    from benchmark.reference.sfc import refine
    from fewshot_vit_tpu_torch.heads.deepemd import sfc_perms, sfc_refine

    g = torch.Generator().manual_seed(0)
    way, shot, n, c = 5, 5, 13, 32
    support = torch.randn(2, way * shot, n, c, generator=g)
    query = torch.randn(2, 15, n, c, generator=g)
    proto = support.reshape(2, shot, way, n, c).mean(1)
    perms = sfc_perms(range(2), 10, way * shot, 7)
    got = sfc_refine(proto, support, way, shot, steps=10, lr=100.0, batch_size=4, perms=perms)
    want = refine(proto, support, perms, way, 100.0, 4, 12.5, 0.05, 100)
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())
    logits = emd_logits(got, query, 12.5, 0.05, 100)
    assert float((logits - emd_logits(want, query, 12.5, 0.05, 100)).abs().max()) < 1e-4
