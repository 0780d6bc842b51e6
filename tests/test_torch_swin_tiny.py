"""Swin-T (``swin_tiny_patch4_window7_224``) in the port: the encoder
against the benchmark's plain reference (``benchmark/reference/swin.py``,
written from the paper) on seeded weights at a small shifted size, the
registry entry's published widths on the meta device, and the spans and
window counter of one traced forward."""

import math

import pytest
import torch

from benchmark import inputs
from benchmark.reference.swin import Encoder, param_shapes
from fewshot_vit_tpu_torch.core import trace
from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.models.swin import SwinTransformer

# 56 px, window 7: stage 1 is a 14 x 14 grid of four windows whose odd
# block shifts by 3; stage 2 a single 7 x 7 window, unshifted
SMALL = dict(img_size=56, patch_size=4, window_size=7, embed_dim=32, depths=(2, 2),
             num_heads=(2, 4), mlp_ratio=4.0, qkv_bias=True)
# the benchmark configuration's scales: linear kernels at 1 / sqrt(fan_in),
# so every branch moves the residual stream, bias tables at std 1
BIAS_STD = 1.0


@pytest.fixture(autouse=True)
def fresh_registry():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _pair(seed):
    """The port's encoder and the reference on the same seeded weights."""
    params = inputs.weights(param_shapes(SMALL), seed, "cpu")
    for k, v in params.items():
        if k.endswith("relative_position_bias_table"):
            v.mul_(BIAS_STD / 0.02)
        elif v.dim() == 2:
            v.mul_(1.0 / math.sqrt(v.shape[1]) / 0.02)
    port = SwinTransformer(**SMALL, drop_path_rate=0.0, device="cpu", seed=0)
    port.load_state_dict(params, strict=True)
    x = torch.randn(4, 56, 56, 3, generator=torch.Generator().manual_seed(seed))
    return port, Encoder(params, SMALL), x


@pytest.mark.parametrize("seed", [1, 2**32 + 5])
def test_port_matches_the_reference(seed):
    """Both compute in fp32 on the CPU; they differ only in the order of
    summation (``F.linear`` on the whole map against per-window einsums,
    the bias gathered from another index expression), a few fp32 ulps per
    layer over 4 blocks and a merge: 1e-4 on activations of order 1, 1e-5
    on their token mean."""
    port, ref, x = _pair(seed)
    with torch.no_grad():
        dense, pooled = port(x)
        r_dense, r_pooled = ref(x)
    assert dense.shape == r_dense.shape == (4, 7, 7, 64)
    assert torch.allclose(dense, r_dense, atol=1e-4, rtol=1e-4)
    assert torch.allclose(pooled, r_pooled, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("broken", ["no_shift", "no_rel_bias"])
def test_the_comparison_sees_the_shift_and_the_bias(broken):
    """At this size the shifted block and the bias tables each move the
    output far beyond the tolerance above, so the comparison holds them."""
    port, ref, x = _pair(3)
    with torch.no_grad():
        for blk in port.layers[0].blocks[1::2]:
            if broken == "no_shift":
                blk.shift, blk.attn_mask = 0, None
        if broken == "no_rel_bias":
            for name, p in port.named_parameters():
                if name.endswith("relative_position_bias_table"):
                    p.zero_()
        dense, _ = port(x)
        r_dense, _ = ref(x)
    assert float((dense - r_dense).abs().max()) > 1e-2


def test_registry_entry_has_the_published_widths():
    with torch.device("meta"):
        enc = models.make("swin_tiny_patch4_window7_224", device="meta")
    assert sum(p.numel() for p in enc.parameters()) == 27_519_354
    assert enc.out_dim == 768
    assert [len(s.blocks) for s in enc.layers] == [2, 2, 6, 2]
    assert [s.blocks[0].attn.num_heads for s in enc.layers] == [3, 6, 12, 24]
    want = {k: torch.Size(v) for k, v in param_shapes(dict(
        img_size=224, patch_size=4, window_size=7, embed_dim=96, depths=(2, 2, 6, 2),
        num_heads=(3, 6, 12, 24))).items()}
    assert {k: v.shape for k, v in enc.state_dict().items()} == want


def test_traced_forward_records_stages_windows_and_their_count():
    """One forward of two images at 224 px on the meta device: the stem,
    four stages, a window-attention span in each of the 12 blocks, and
    64 * 2 + 16 * 2 + 4 * 6 + 1 * 2 = 186 windows an image."""
    with torch.device("meta"):
        enc = models.make("swin_tiny_patch4_window7_224", dtype=torch.bfloat16, device="meta")
    trace.enable()
    with torch.no_grad():
        dense, pooled = enc(torch.empty(2, 224, 224, 3, device="meta"))
    snap = trace.reset()
    assert tuple(dense.shape) == (2, 7, 7, 768) and tuple(pooled.shape) == (2, 768)
    spans = snap["spans"]
    for name in ["encoder", "encoder.stem"] + [f"encoder.stage{i}" for i in range(1, 5)]:
        assert len(spans[name]) == 1, name
    attn = spans["encoder.window_attn"]
    assert len(attn) == 12
    assert [s["parent"] for s in attn] == ["encoder.stage1"] * 2 + ["encoder.stage2"] * 2 + [
        "encoder.stage3"] * 6 + ["encoder.stage4"] * 2
    assert snap["counters"]["encoder.windows"] == 186 * 2
    assert spans["encoder"][0]["counts"]["encoder.windows"] == 186 * 2
    assert math.isclose(sum(s["counts"]["encoder.windows"] for s in attn), 372)
