"""NesT-T (``nest_tiny_s196_224``) in the port: the encoder against the
benchmark's plain reference (``benchmark/reference/nest.py``, written from
the paper) on seeded weights at a small size, the registry entry's
published widths on the meta device, and the spans and block counter of one
traced forward."""

import math

import pytest
import torch

from benchmark import inputs
from benchmark.drivers.nest_episodic_eval import head_major
from benchmark.reference.nest import Encoder, param_shapes
from fewshot_vit_tpu_torch.core import trace
from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.models.nest import Nest

# 32 px, patch 2: a 16 x 16 token map in 16 / 4 / 1 blocks of 4 x 4 tokens,
# so every block holds four token rows and each ConvPool halves the map
SMALL = dict(img_size=32, patch_size=2, embed_dims=(16, 32, 48), num_heads=(2, 2, 4),
             depths=(1, 1, 2), mlp_ratio=4.0, qkv_bias=True)
NEST_T = dict(img_size=224, patch_size=4, embed_dims=(96, 192, 384), num_heads=(3, 6, 12),
              depths=(2, 2, 8))
# the benchmark configuration's scales: linear kernels at 1 / sqrt(fan_in),
# so every branch moves the residual stream, positional embeddings at 0.25
POS_STD = 0.25


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
        if k.endswith("pos_embed"):
            v.mul_(POS_STD / 0.02)
        elif v.dim() == 2:
            v.mul_(1.0 / math.sqrt(v.shape[1]) / 0.02)
    port = Nest(**SMALL, drop_path_rate=0.0, device="cpu", seed=0)
    port.load_state_dict(params, strict=True)
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(seed))
    return port, Encoder(params, SMALL), x


@pytest.mark.parametrize("seed", [1, 2**32 + 5])
def test_port_matches_the_reference(seed):
    """Both compute in fp32 on the CPU; they differ only in the order of
    summation (``F.linear`` and ``F.conv2d`` against the same calls on other
    layouts, the einsums' operand orders), a few fp32 ulps a layer over four
    layers and two ConvPools: 1e-4 on activations of order 1, 1e-5 on their
    token mean."""
    port, ref, x = _pair(seed)
    with torch.no_grad():
        dense, pooled = port(x)
        r_dense, r_pooled = ref(x)
    assert dense.shape == r_dense.shape == (4, 4, 4, 48)
    assert torch.allclose(dense, r_dense, atol=1e-4, rtol=1e-4)
    assert torch.allclose(pooled, r_pooled, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("broken", ["no_pos_embed", "merge_head_major"])
def test_the_comparison_sees_the_positions_and_the_head_merge(broken):
    """At this size the positional embeddings and the head-dim-major merge
    each move the output far beyond the tolerance above, so the comparison
    holds them."""
    port, ref, x = _pair(3)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if broken == "no_pos_embed" and name.endswith("pos_embed"):
                p.zero_()
        if broken == "merge_head_major":
            for level in port.levels:
                for layer in level.transformer_encoder:
                    w = layer.attn.proj.weight
                    w.copy_(head_major(w, layer.attn.num_heads))
        dense, _ = port(x)
        r_dense, _ = ref(x)
    assert float((dense - r_dense).abs().max()) > 1e-2


def test_head_major_permutes_the_proj_columns():
    """Column d * H + h of the permuted kernel is column h * d_head + d."""
    w = torch.arange(12.0).reshape(1, 12)
    got = head_major(w, 3)[0].tolist()
    assert got == [h * 4 + d for d in range(4) for h in range(3)]


def test_registry_entry_has_the_published_widths():
    with torch.device("meta"):
        enc = models.make("nest_tiny_s196_224", device="meta")
    assert sum(p.numel() for p in enc.parameters()) == 16_672_608
    assert enc.out_dim == 384
    assert [len(lv.transformer_encoder) for lv in enc.levels] == [2, 2, 8]
    assert [lv.transformer_encoder[0].attn.num_heads for lv in enc.levels] == [3, 6, 12]
    assert [tuple(lv.pos_embed.shape) for lv in enc.levels] == [
        (1, 16, 196, 96), (1, 4, 196, 192), (1, 1, 196, 384)]
    want = {k: torch.Size(v) for k, v in param_shapes(NEST_T).items()}
    assert {k: v.shape for k, v in enc.state_dict().items()} == want


@pytest.mark.parametrize("name,size,blocks,layers", [("nest_tiny_s196_224", 224, 48, 12),
                                                     ("nest_nano_80", 80, 47, 8)])
def test_traced_forward_records_levels_blocks_and_their_count(name, size, blocks, layers):
    """One forward of two images on the meta device: the stem, three
    levels, a block-attention span in each transformer layer, and the
    blocks attended: NesT-T 16 * 2 + 4 * 2 + 1 * 8 = 48 an image, the
    80 px nano 16 * 2 + 4 * 3 + 1 * 3 = 47."""
    with torch.device("meta"):
        enc = models.make(name, dtype=torch.bfloat16, device="meta")
    trace.enable()
    with torch.no_grad():
        dense, pooled = enc(torch.empty(2, size, size, 3, device="meta"))
    snap = trace.reset()
    assert tuple(pooled.shape) == (2, enc.out_dim) and dense.shape[-1] == enc.out_dim
    spans = snap["spans"]
    for span in ["encoder", "encoder.stem"] + [f"encoder.stage{i}" for i in range(1, 4)]:
        assert len(spans[span]) == 1, span
    assert spans["encoder.stem"][0]["parent"] == "encoder"
    attn = spans["encoder.block_attn"]
    depths = [len(lv.transformer_encoder) for lv in enc.levels]
    assert len(attn) == layers == sum(depths)
    assert [s["parent"] for s in attn] == [f"encoder.stage{i}" for i, d in enumerate(depths, 1)
                                           for _ in range(d)]
    assert snap["counters"]["encoder.blocks"] == blocks * 2
    assert spans["encoder"][0]["counts"]["encoder.blocks"] == blocks * 2
    # the final norm sits in the last level, the block norms outside the attention
    norms = spans["encoder.norm"]
    assert norms[-1]["parent"] == "encoder.stage3"
    assert "encoder.block_attn" not in {s["parent"] for s in norms}


def test_bf16_rows_are_the_convpool_norms_chip_smoke_checks():
    """A bf16 NesT-T forward on the meta device hands LayerNorm bf16 rows
    only in its two block aggregations; at the NesT cell's 2,560-image batch
    they are the shapes ``chip_smoke.py`` phase 40 holds the kernel to
    (``NEST_T_LAYER_NORM_SHAPES``). The other 25 norms get fp32 rows."""
    import importlib.util
    from pathlib import Path

    from fewshot_vit_tpu_torch.models.common import LayerNorm

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_nest", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    seen = []
    with torch.device("meta"):
        enc = models.make("nest_tiny_s196_224", dtype=torch.bfloat16, device="meta")
    for m in enc.modules():
        if isinstance(m, LayerNorm):
            m.register_forward_pre_hook(lambda mod, args: seen.append(
                (args[0].dtype, args[0].numel() // 2 // args[0].shape[-1], args[0].shape[-1])))
    with torch.no_grad():
        enc(torch.empty(2, 224, 224, 3, device="meta"))
    bf16 = [(2560 * rows, c) for dtype, rows, c in seen if dtype == torch.bfloat16]
    assert tuple(bf16) == smoke.NEST_T_LAYER_NORM_SHAPES
    assert sum(dtype == torch.float32 for dtype, _, _ in seen) == 25
