"""``block_fused_pct.eval`` on the CPU: a tiny traced NesT run reads 0 (off
the card every block takes the einsum path), spans whose blocks were fused
read their share, and a program that does not count fused blocks (a tree
before the block kernel) or has no registry gives nothing."""

from __future__ import annotations

import sys

import torch

from benchmark.core import Run, execute, read_metric
from benchmark.tests.tiny import tiny

CPU = torch.device("cpu")
NAME = "block_fused_pct.eval"


def _run():
    return Run("w", "eval", "episodes", 1.0, 1.0, 1, 1.0, 1.0, trace=object())


def test_a_tiny_traced_nest_run_reads_no_fused_block():
    out = execute(tiny("sunm_eval_nest_tiny_224"), CPU, 2**31 + 29, 0.05, True, 0.0)
    assert out["correct"], out["checks"]
    assert out["metrics"][NAME]["value"] == 0


def test_the_reader_takes_the_share_of_the_counted_blocks(monkeypatch):
    from fewshot_vit_tpu_torch.core import trace

    def spans(*counts):
        return {"spans": {"encoder.block_attn": [{"counts": c} for c in counts]}}

    fused = spans({"encoder.blocks": 32, "encoder.blocks_fused": 32},
                  {"encoder.blocks": 8, "encoder.blocks_fused": 0})
    monkeypatch.setattr(trace, "snapshot", lambda: fused)
    assert read_metric(NAME, _run()) == 100.0 * 32 / 40
    # the parent's spans: blocks counted, fused blocks not
    monkeypatch.setattr(trace, "snapshot", lambda: spans({"encoder.blocks": 32}))
    assert read_metric(NAME, _run()) is None
    monkeypatch.setattr(trace, "snapshot", lambda: {"spans": {}})
    assert read_metric(NAME, _run()) is None


def test_a_program_without_the_registry_gives_nothing(monkeypatch):
    import fewshot_vit_tpu_torch.core as core

    monkeypatch.delattr(core, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "fewshot_vit_tpu_torch.core.trace", None)
    assert read_metric(NAME, _run()) is None
