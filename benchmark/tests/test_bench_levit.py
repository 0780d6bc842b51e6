"""The LeViT cell at its driver's tiny size on the CPU: a traced run reads
the biased-attention metrics, each fault breaks the check, the readers read
nothing from a program without the spans or with another count of scores,
and the LeViT roofline's arithmetic at 80 px."""

from __future__ import annotations

import sys

import pytest
import torch

from benchmark.core import Run, execute, read_metric
from benchmark.metrics import _program_trace
from benchmark.reference.levit import attentions, scores_per_image
from benchmark.roofline import HBM_BYTES_PER_S, PEAK_FLOPS
from benchmark.roofline_levit import bias_attention_bound, call_flops
from benchmark.tests.tiny import tiny

CPU = torch.device("cpu")
LEVIT = "sunm_eval_levit_micro_80"
MICRO = dict(img_size=80, embed_dim=(256, 384, 512), key_dim=32, depth=(1, 2, 3),
             num_heads=(4, 6, 8), attn_ratio=2, mlp_ratio=2, stem_hidden=64)
BIAS_METRICS = ("bias_attn_ms.eval", "bias_attn_roofline_pct.eval")


@pytest.mark.parametrize("fault", ["no_attn_bias", "bias_stride_1", "no_hardswish"])
def test_fault_is_not_correct(fault):
    for seed in (5, 2**32 + 3):
        out = execute(tiny(LEVIT), CPU, seed, 0.05, False, 0.0, fault=fault)
        assert not out["correct"], out["checks"]


def test_traced_levit_run_reads_the_biased_attention():
    out = execute(tiny(LEVIT), CPU, 2**31 + 23, 0.05, True, 0.0)
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    assert 0 < metrics["bias_attn_ms.eval"]["value"] < metrics["encoder_ms.eval"]["value"]
    assert 0 < metrics["bias_attn_roofline_pct.eval"]["value"] <= 100
    assert not {"block_attn_ms.eval", "window_attn_ms.eval"} & set(metrics)


def _run():
    return Run(LEVIT, "eval", "episodes", 1.0, 1.0, 1, 1.0, 1.0, trace=object(),
               extra={"encoder_args": MICRO, "dtype": "bfloat16", "images_per_batch": 10240})


def test_bias_readers_give_nothing_without_the_spans(monkeypatch):
    """A traced run of a NesT cell, and a program without the registry (an
    older parent): the readers return None."""
    out = execute(tiny("sunm_eval_nest_tiny_224"), CPU, 2**31 + 23, 0.05, True, 0.0)
    assert not set(BIAS_METRICS) & set(out["metrics"])
    import fewshot_vit_tpu_torch.core as core

    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "fewshot_vit_tpu_torch.core.trace", None)
    assert all(read_metric(name, _run()) is None for name in BIAS_METRICS)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_roofline_reader_holds_the_count_of_scores(monkeypatch, scale):
    """Two batches of 10,240 images, 8 spans a batch of 10 ms each: the
    share reads the bound over 160 ms where the spans counted every score,
    and nothing where they counted half."""
    per_call = 10240 * scores_per_image(MICRO) * scale / 8
    spans = {"encoder.bias_attn": [{"device_ms": 10.0, "counts": {"encoder.attn_scores":
                                                                   per_call}}] * 16,
             "eval.batch": [{"device_ms": 200.0, "counts": {}}] * 2}
    monkeypatch.setattr(_program_trace, "_spans", lambda run, kind, name: spans.get(name, []))
    got = read_metric("bias_attn_roofline_pct.eval", _run())
    if scale < 1:
        assert got is None
    else:
        want = 100 * bias_attention_bound(MICRO, 2 * 10240, 2, "bfloat16") / 160.0
        assert got == pytest.approx(want, rel=1e-12)
        assert read_metric("bias_attn_ms.eval", _run()) == pytest.approx(80.0)


def test_levit_roofline_counts_the_spans_work():
    """levit_micro_80 at 80 px: 1,125,000 scores and 1.26 GFLOP of biased
    attention an image, every call bound by its flops. By hand, a call's
    projections (qkv, or kv and q; proj) and its 2 Nq Nkv h (kd + d) of
    q k^T and p v, at (C_in, C_out, h, d, Nq, Nkv):"""
    assert scores_per_image(MICRO) == 1_125_000
    by_hand = [
        2 * 400 * 256 * 512 + 2 * 400 * 400 * 4 * 96 + 2 * 400 * 256 * 256,        # stage 1
        2 * 400 * 256 * 1280 + 2 * 100 * 256 * 256 + 2 * 100 * 400 * 8 * 160
        + 2 * 100 * 1024 * 384,                                                   # 20 -> 10
        2 * 100 * 384 * 768 + 2 * 100 * 100 * 6 * 96 + 2 * 100 * 384 * 384,        # stage 2
        2 * 100 * 384 * 768 + 2 * 100 * 100 * 6 * 96 + 2 * 100 * 384 * 384,
        2 * 100 * 384 * 1920 + 2 * 25 * 384 * 384 + 2 * 25 * 100 * 12 * 160
        + 2 * 25 * 1536 * 512,                                                    # 10 -> 5
    ] + [2 * 25 * 512 * 1024 + 2 * 25 * 25 * 8 * 96 + 2 * 25 * 512 * 512] * 3    # stage 3
    assert [call_flops(a) for a in attentions(MICRO)] == by_hand
    assert sum(by_hand) == 1_261_043_200
    images = 10240
    want = 0.0
    for a, flops in zip(attentions(MICRO), by_hand):
        acts = images * (a.res_kv ** 2 * a.cin + a.res_q ** 2 * a.cout) * 2
        by_bytes = acts / HBM_BYTES_PER_S
        by_flops = images * flops / PEAK_FLOPS["bfloat16"]
        assert by_flops > 2 * by_bytes
        want += by_flops
    got = bias_attention_bound(MICRO, images, 1, "bfloat16")
    assert got == pytest.approx(want * 1e3, rel=1e-12)
    assert 13.0 < got < 13.1
    assert bias_attention_bound(MICRO, images, 1, "float32") > 3 * got
