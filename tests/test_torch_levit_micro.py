"""LeViT (``levit_micro_80``) in the port: the encoder against the
benchmark's plain reference (``benchmark/reference/levit.py``, written from
the paper and SUN's code) on seeded weights at a small size, unfolded and
folded, the faults the benchmark's check must see, the registry entry's
published widths, and the spans and score counter of one traced forward."""

import math

import pytest
import torch

from benchmark import inputs
from benchmark.drivers.levit_episodic_eval import FAULTS, break_program
from benchmark.reference.levit import (Encoder, attentions, bias_index, param_shapes,
                                       scores_per_image)
from fewshot_vit_tpu_torch.core import trace
from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.models.fold import fold_levit
from fewshot_vit_tpu_torch.models.levit import Levit, attention_bias_idxs

# 32 px: an 8 x 8 token map, subsampled to 4 x 4 and 2 x 2; key width 8,
# value widths 16 in the blocks and 32 in the subsampling attention
SMALL = dict(img_size=32, embed_dim=(32, 48, 64), key_dim=8, depth=(1, 1, 1),
             num_heads=(2, 3, 4), attn_ratio=2, mlp_ratio=2, stem_hidden=16)
MICRO = dict(img_size=80, embed_dim=(256, 384, 512), key_dim=32, depth=(1, 2, 3),
             num_heads=(4, 6, 8), attn_ratio=2, mlp_ratio=2, stem_hidden=64)
# the benchmark configuration's scales: linear kernels at 1 / sqrt(fan_in),
# bias tables at std 1
BIAS_STD = 1.0


@pytest.fixture(autouse=True)
def fresh_registry():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _weights(seed):
    """Seeded weights as the benchmark draws them, BN statistics set from a
    batch through the reference; and an input of four images."""
    params = inputs.weights(param_shapes(SMALL), seed, "cpu")
    for k, v in params.items():
        if k.endswith("attention_biases"):
            v.mul_(BIAS_STD / 0.02)
        elif v.dim() == 2:
            v.mul_(1.0 / math.sqrt(v.shape[1]) / 0.02)
    gen = torch.Generator().manual_seed(seed)
    calib = Encoder(params, SMALL, bn="batch")
    with torch.no_grad():
        calib(torch.randn(16, 32, 32, 3, generator=gen))
    for k, v in calib.stats.items():
        params[k].copy_(v)
    return params, torch.randn(4, 32, 32, 3, generator=gen)


def _rel(got, want):
    """The rms of the difference over the rms of ``want``."""
    return float((got - want).norm() / want.norm())


def _port(params, fold_bn=False):
    port = Levit(**SMALL, fold_bn=fold_bn, device="cpu", seed=0)
    port.load_state_dict(fold_levit(params) if fold_bn else params, strict=True)
    return port


@pytest.mark.parametrize("fold_bn", [False, True])
@pytest.mark.parametrize("seed", [1, 2**32 + 5])
def test_port_matches_the_reference(seed, fold_bn):
    """Both compute in fp32 on the CPU. Unfolded they differ only in the
    order of summation (the convs and linear maps on other layouts, the
    einsums' operand orders): a few fp32 ulps (6e-8) a sum, over sums of up
    to 576 terms and 20 layers, reads 3e-6 to 1e-5 relative. The fold
    multiplies each BN's scale into its kernel in float64 and rounds it to
    fp32, one more rounding a layer: 6e-6 to 2e-5. The residual stream
    grows to a std of 3 to 14 over the blocks, so the measure is relative:
    5e-5 of the reference's rms, on the tokens and on their mean."""
    params, x = _weights(seed)
    ref = Encoder(params, SMALL)
    with torch.no_grad():
        dense, pooled = _port(params, fold_bn)(x)
        r_dense, r_pooled = ref(x)
    assert dense.shape == r_dense.shape == (4, 2, 2, 64)
    assert _rel(dense, r_dense) < 5e-5
    assert _rel(pooled, r_pooled) < 5e-5


@pytest.mark.parametrize("fault", FAULTS)
def test_the_comparison_sees_each_fault(fault):
    """Each fault the benchmark's check holds (a zeroed bias table, the
    subsampling offsets at stride 1, no hard-swish before proj) moves the
    folded program's output far beyond the tolerance above."""
    params, x = _weights(3)
    port = _port(params, fold_bn=True)
    break_program(port, fault)
    with torch.no_grad():
        dense, pooled = port(x)
        r_dense, r_pooled = Encoder(params, SMALL)(x)
    assert _rel(dense, r_dense) > 1e-2
    assert _rel(pooled, r_pooled) > 1e-2


@pytest.mark.parametrize("res_q,res_kv,stride", [(20, 20, 1), (10, 20, 2), (5, 10, 2),
                                                 (3, 5, 2), (4, 4, 1)])
def test_offset_tables_agree(res_q, res_kv, stride):
    """The reference's closed form, offset (dy, dx) at dy * res_kv + dx, is
    the port's table numbered in order of first appearance; at stride 1
    the subsampling table (the fault) is another table of the same size."""
    idxs, n = attention_bias_idxs(res_q, res_kv, stride)
    assert n == res_kv ** 2
    assert torch.equal(torch.from_numpy(idxs), bias_index(res_q, res_kv, stride))
    if stride > 1:
        at_1, n_1 = attention_bias_idxs(res_q, res_kv, 1)
        assert n_1 == n and not (at_1 == idxs).all()


def test_registry_entry_has_the_published_widths():
    with torch.device("meta"):
        enc = models.make("levit_micro_80", device="meta")
    assert sum(p.numel() for p in enc.parameters()) == 12_925_112
    assert enc.out_dim == 512 and enc.res == 5
    want = {k: torch.Size(v) for k, v in param_shapes(MICRO).items()}
    assert {k: v.shape for k, v in enc.state_dict().items()} == want
    assert [(a.heads, a.kd, a.d, a.res_q, a.res_kv) for a in attentions(MICRO)] == [
        (4, 32, 64, 20, 20), (8, 32, 128, 10, 20), (6, 32, 64, 10, 10), (6, 32, 64, 10, 10),
        (12, 32, 128, 5, 10), (8, 32, 64, 5, 5), (8, 32, 64, 5, 5), (8, 32, 64, 5, 5)]


@pytest.mark.parametrize("name,cfg,size,calls,scores", [
    ("levit_micro_80", MICRO, 80, 8,
     4 * 400 ** 2 + 8 * 100 * 400 + 2 * 6 * 100 ** 2 + 12 * 25 * 100 + 3 * 8 * 25 ** 2),
    ("small", SMALL, 32, 5, 2 * 64 ** 2 + 4 * 16 * 64 + 3 * 16 ** 2 + 6 * 4 * 16 + 4 * 4 ** 2)])
def test_traced_forward_records_stages_attention_and_scores(name, cfg, size, calls, scores):
    """One bf16 forward of two images on the meta device: the stem, three
    stages, a biased-attention span in each attention call (the stages' and
    the two subsampling ones), and the scores: levit_micro_80 1,125,000 an
    image at 80 px."""
    with torch.device("meta"):
        enc = (models.make(name, dtype=torch.bfloat16, device="meta") if name != "small"
               else Levit(**cfg, dtype=torch.bfloat16, device="meta"))
    trace.enable()
    with torch.no_grad():
        dense, pooled = enc(torch.empty(2, size, size, 3, device="meta"))
    snap = trace.reset()
    assert tuple(pooled.shape) == (2, enc.out_dim) and dense.shape[-1] == enc.out_dim
    spans = snap["spans"]
    for span in ["encoder", "encoder.stem"] + [f"encoder.stage{i}" for i in range(1, 4)]:
        assert len(spans[span]) == 1, span
    assert spans["encoder.stem"][0]["parent"] == "encoder"
    attn = spans["encoder.bias_attn"]
    assert len(attn) == calls == len(attentions(cfg))
    depth = cfg["depth"]
    assert [s["parent"] for s in attn] == (
        ["encoder.stage1"] * depth[0] + ["encoder.stage2"] * (1 + depth[1])
        + ["encoder.stage3"] * (1 + depth[2]))
    assert scores == scores_per_image(cfg)
    assert snap["counters"]["encoder.attn_scores"] == 2 * scores
    assert sum(s["counts"]["encoder.attn_scores"] for s in attn) == 2 * scores
    assert spans["encoder"][0]["counts"]["encoder.attn_scores"] == 2 * scores
