"""The NesT-T cell at its driver's tiny size on the CPU: each fault breaks
the check, the block-attention readers read a traced run and nothing from a
program without the spans, a program without the NesT-T encoder stops
before the split is made, and the block roofline's arithmetic."""

from __future__ import annotations

import sys

import pytest
import torch

from benchmark import inputs
from benchmark.core import Run, execute, read_metric
from benchmark.roofline import HBM_BYTES_PER_S, PEAK_FLOPS
from benchmark.roofline_block import block_attention_bound, blocks_per_image
from benchmark.tests.tiny import tiny

CPU = torch.device("cpu")
NEST = "sunm_eval_nest_tiny_224"
NEST_T = dict(img_size=224, patch_size=4, embed_dims=(96, 192, 384), num_heads=(3, 6, 12),
              depths=(2, 2, 8))
BLOCK_METRICS = ("block_attn_ms.eval", "block_attn_roofline_pct.eval")


@pytest.mark.parametrize("fault", ["no_pos_embed", "merge_head_major"])
def test_fault_is_not_correct(fault):
    for seed in (5, 2**32 + 3):
        out = execute(tiny(NEST), CPU, seed, 0.05, False, 0.0, fault=fault)
        assert not out["correct"], out["checks"]


def test_traced_nest_run_reads_the_block_attention_and_the_norms():
    out = execute(tiny(NEST), CPU, 2**31 + 23, 0.05, True, 0.0)
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    assert metrics["block_attn_ms.eval"]["value"] > 0
    assert 0 < metrics["block_attn_roofline_pct.eval"]["value"] <= 100
    # off the card no LayerNorm takes the kernel
    assert metrics["layer_norm_fused_pct.eval"]["value"] == 0
    assert not {"window_attn_ms.eval", "window_fused_pct.eval"} & set(metrics)


def test_block_readers_give_nothing_without_the_spans(monkeypatch):
    """A traced run of a Swin cell, and a program without the registry (an
    older parent): the readers return None."""
    out = execute(tiny("sunm_eval_swin_tiny_224"), CPU, 2**31 + 23, 0.05, True, 0.0)
    assert not set(BLOCK_METRICS) & set(out["metrics"])
    import fewshot_vit_tpu_torch.core as core

    run = Run("w", "eval", "episodes", 1.0, 1.0, 1, 1.0, 1.0, trace=object(),
              extra={"encoder_args": NEST_T, "dtype": "bfloat16"})
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "fewshot_vit_tpu_torch.core.trace", None)
    assert all(read_metric(name, run) is None for name in BLOCK_METRICS)


def test_a_program_without_the_encoder_stops_before_the_split(monkeypatch):
    import fewshot_vit_tpu_torch.models  # noqa: F401  (fills the registry)
    from fewshot_vit_tpu_torch.core.registry import models

    monkeypatch.delitem(models._ctors, "nest_tiny_s196_224")
    made = []
    monkeypatch.setattr(inputs, "split", lambda *a, **k: made.append(a))
    with pytest.raises(KeyError, match="nest_tiny_s196_224"):
        execute(tiny(NEST), CPU, 7, 0.05, False, 0.0)
    assert made == []


def test_block_roofline_counts_the_spans_work():
    """NesT-T at 224 px: 48 blocks of 196 tokens an image. A layer's span
    reads its input and writes its output, 196 tokens by C channels a block
    in bf16, and does 8 n C^2 + 4 n^2 C flops a block; at 196 tokens every
    level is bound by its flops. The weights, read once a forward, add a few
    MB. About 10.2 ms for 2,560 images."""
    assert blocks_per_image(NEST_T) == 16 * 2 + 4 * 2 + 1 * 8 == 48
    images, n = 2560, 196
    want = 0.0
    for blocks, c, depth in ((16, 96, 2), (4, 192, 2), (1, 384, 8)):
        act = images * blocks * 2 * n * c * 2
        weights = (4 * c * c + 3 * c + c) * 2
        flops = images * blocks * (8 * n * c * c + 4 * n * n * c)
        by_bytes = (act + weights) / HBM_BYTES_PER_S
        by_flops = flops / PEAK_FLOPS["bfloat16"]
        assert by_flops > by_bytes
        want += depth * max(by_bytes, by_flops)
    got = block_attention_bound(NEST_T, 48 * images, 1, "bfloat16")
    assert got == pytest.approx(want * 1e3, rel=1e-12)
    assert 10.2 < got < 10.3
    assert block_attention_bound(NEST_T, 48 * images, 1, "float32") > 3 * got
