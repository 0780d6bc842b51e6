"""NesT's block attention op (``kernels/block.py``) on the CPU: its plain
implementation, with the proj projection over its input columns in the
kernel's head-major merge order, held to ``NestAttention``'s einsum path
(head-dim-major merge) on the same layer; the route a layer takes; the
counters under the ``encoder.block_attn`` span; and the op's registration."""

import functools
import importlib.util
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from fewshot_vit_tpu_torch.core import trace
from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.kernels import block as tb
from fewshot_vit_tpu_torch.kernels.bench import BLOCK_REL_RMS, block_off, block_rel_rms
from fewshot_vit_tpu_torch.models import nest
from fewshot_vit_tpu_torch.models.common import capture_attention, init_weights

# (blocks an image, tokens, channels, heads), hd 32: NesT-T's three levels at
# 224 px, nest_micro_80's level 1 and nest_micro_resembed_2x_80's last level
LEVELS = [(16, 196, 96, 3), (4, 196, 192, 6), (1, 196, 384, 12), (16, 25, 128, 4),
          (1, 100, 512, 16)]
# a 32 px NesT, patch 2: 16 / 4 / 1 blocks of 4 x 4 tokens, hd 8 and 16
SMALL = dict(img_size=32, patch_size=2, embed_dims=(16, 32, 48), num_heads=(2, 2, 4),
             depths=(1, 1, 2), drop_path_rate=0.0)


@pytest.fixture(autouse=True)
def fresh_registry():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _attention(c, heads, seed, dtype=torch.float32):
    """A NesT attention layer with the benchmark's scales: linear kernels at
    1 / sqrt(fan_in), so the attention pattern shows in the output."""
    attn = nest.NestAttention(c, heads, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    init_weights(attn, gen)
    with torch.no_grad():
        for p in attn.parameters():
            if p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1]))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return attn.eval()


def _tokens(per_image, n, c, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(1, per_image, n, c, generator=gen).to(dtype)


@pytest.mark.parametrize("per_image,n,c,heads", [pytest.param(*lv, id="{}-{}-{}-{}".format(*lv))
                                                 for lv in LEVELS])
def test_op_matches_the_einsum_path(per_image, n, c, heads):
    """fp32, one image: qkv, the op's plain version (heads merged head-major)
    and proj over its permuted columns against qkv, the einsums, the
    head-dim-major merge and proj. They differ only in the order of
    summation."""
    attn = _attention(c, heads, n + c)
    y = _tokens(per_image, n, c, n + heads)
    with torch.no_grad():
        want = attn(y)
        got = attn.fused(y)
    assert got.shape == want.shape == (1, per_image, n, c)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_op_matches_the_einsum_path_in_bf16():
    """bf16: the op keeps scores and softmax in fp32 where the einsum path
    rounds them, so the two differ by bf16 roundings of outputs of order 1."""
    attn = _attention(192, 6, 7, torch.bfloat16)
    y = _tokens(4, 196, 192, 7, torch.bfloat16)
    with torch.no_grad():
        want = attn(y).float()
        got = attn.fused(y).float()
    assert (got - want).abs().max().item() <= 0.05
    assert (got - want).abs().mean().item() <= 0.005


def test_reference_is_the_attention_of_each_head():
    """Head h of the plain version's output (channels h * hd .. h * hd + hd - 1)
    is softmax(q_h k_h^T * scale) v_h over the block, in fp32."""
    gen = torch.Generator().manual_seed(4)
    b, t, n, heads, hd = 2, 3, 25, 4, 32
    qkv = torch.randn(b, t, n, 3 * heads * hd, generator=gen)
    got = tb.block_attention_reference(qkv, heads, hd ** -0.5)
    q, k, v = qkv.reshape(b, t, n, 3, heads, hd).unbind(3)
    for h in range(heads):
        p = torch.softmax(q[..., h, :] @ k[..., h, :].transpose(-1, -2) * hd ** -0.5, dim=-1)
        torch.testing.assert_close(got[..., h * hd:(h + 1) * hd], p @ v[..., h, :],
                                   rtol=1e-5, atol=1e-5)


def _rounded_in_float64(qkv, heads, scale):
    """The kernel's roundings (probabilities and output to bf16) around exact
    arithmetic: what a sound kernel may differ from the plain version by."""
    b, t, n, c3 = qkv.shape
    q, k, v = qkv.reshape(b, t, n, 3, heads, c3 // 3 // heads).double().unbind(3)
    p = torch.softmax(torch.einsum("btqhd,btkhd->bthqk", q, k) * scale, dim=-1)
    o = torch.einsum("bthqk,btkhd->btqhd", p.to(torch.bfloat16).double(), v)
    return o.to(torch.bfloat16).reshape(b, t, n, c3 // 3)


@pytest.mark.parametrize("per_image,n,c,heads", [(16, 196, 96, 3), (4, 196, 192, 6),
                                                 (16, 25, 128, 4), (1, 100, 512, 16)])
def test_card_rule_fails_a_kernel_that_leaves_padded_keys_unmasked(per_image, n, c, heads):
    """The card checks' relative rms rule (``kernels.bench.block_rel_rms``
    within ``BLOCK_REL_RMS``) at q,k std 1: a kernel whose padded keys (the
    zeroed rows of K and V up to the next multiple of 8 keys) enter the
    softmax unmasked fails it, modelled here as the plain version over the
    block with those zero tokens appended; exact arithmetic rounded where the
    kernel rounds passes it. At 196 tokens the elementwise rule alone, 1e-2 +
    2^-6 |want|, passes the fault."""
    gen = torch.Generator().manual_seed(n + c)
    qkv = torch.randn(2, per_image, n, 3 * c, generator=gen).to(torch.bfloat16)
    scale = 32 ** -0.5
    want = tb.block_attention_reference(qkv, heads, scale)
    pad = -n % 8
    unmasked = tb.block_attention_reference(F.pad(qkv, (0, 0, 0, pad)), heads, scale)[:, :, :n]
    sound = _rounded_in_float64(qkv, heads, scale)
    assert block_rel_rms(sound, want) <= BLOCK_REL_RMS / 4
    assert block_rel_rms(unmasked, want) >= 4 * BLOCK_REL_RMS
    if n == 196:
        assert block_off(unmasked, want) <= 0


@pytest.mark.parametrize("c,heads", [(96, 3), (192, 6), (384, 12), (128, 4), (512, 16)])
def test_head_major_columns_equal_the_head_dim_major_merge(c, heads):
    """The kernel's merge (channel h * hd + d) is the reference's (channel
    d * H + h) permuted: proj over the permuted columns of the head-major
    output is proj over the head-dim-major output."""
    hd = c // heads
    gen = torch.Generator().manual_seed(c)
    o = torch.randn(5, heads, hd, generator=gen)        # (token, h, d)
    head_major = o.reshape(5, c)                        # channel h * hd + d
    head_dim_major = o.transpose(1, 2).reshape(5, c)    # channel d * H + h
    cols = tb.head_major_columns(c, heads)
    assert torch.equal(head_dim_major[:, cols], head_major)
    assert sorted(cols.tolist()) == list(range(c))
    w = torch.randn(c, c, generator=gen) / math.sqrt(c)
    torch.testing.assert_close(F.linear(head_major, w[:, cols]), F.linear(head_dim_major, w),
                               rtol=1e-5, atol=1e-5)


CUDA = torch.device("cuda")
ROUTE_CASES = {
    # case: (device, dtype, tokens, hd, dropout, kind, grad, capture) -> taken
    "kernel": (CUDA, torch.bfloat16, 196, 32, False, "standard", False, False),
    "tokens_25": (CUDA, torch.bfloat16, 25, 32, False, "standard", False, False),
    "tokens_100": (CUDA, torch.bfloat16, 100, 32, False, "standard", False, False),
    "cpu": (torch.device("cpu"), torch.bfloat16, 196, 32, False, "standard", False, False),
    "fp32": (CUDA, torch.float32, 196, 32, False, "standard", False, False),
    "grad": (CUDA, torch.bfloat16, 196, 32, False, "standard", True, False),
    "capture": (CUDA, torch.bfloat16, 196, 32, False, "standard", False, True),
    "dropout": (CUDA, torch.bfloat16, 196, 32, True, "standard", False, False),
    "rel": (CUDA, torch.bfloat16, 196, 32, False, "rel", False, False),
    "gpsa": (CUDA, torch.bfloat16, 196, 32, False, "gpsa", False, False),
    "head_dim_16": (CUDA, torch.bfloat16, 196, 16, False, "standard", False, False),
    "tokens_49": (CUDA, torch.bfloat16, 49, 32, False, "standard", False, False),
    "tokens_256": (CUDA, torch.bfloat16, 256, 32, False, "standard", False, False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_block_route(case):
    """The kernel's route only for the standard kind on CUDA tensors, in
    bf16, without autograd or capture, with attention dropout off, at hd 32
    and a block of 1 to 200 tokens (NesT's are 25, 100 and 196); each
    condition alone keeps the einsum path."""
    device, dtype, tokens, hd, dropout, kind, grad, capture = ROUTE_CASES[case]
    with torch.set_grad_enabled(grad):
        if capture:
            with capture_attention():
                taken = nest.block_route(device, dtype, tokens, hd, dropout, kind)
        else:
            taken = nest.block_route(device, dtype, tokens, hd, dropout, kind)
    assert taken == (case in ("kernel", "tokens_25", "tokens_100", "tokens_49"))


def test_kernel_takes_the_routed_sizes_only():
    """bf16 at hd 32, 1 to ``MAX_TOKENS`` (200) tokens a block: what the
    source's instantiations hold."""
    for n in (1, 25, 32, 33, 100, 104, 105, 196, 200):
        assert tb.kernel_takes(torch.bfloat16, n, 32)
    for n in (0, 201, 256):
        assert not tb.kernel_takes(torch.bfloat16, n, 32)
    assert not tb.kernel_takes(torch.float16, 196, 32)
    assert not tb.kernel_takes(torch.bfloat16, 196, 16)
    assert tb.MAX_TOKENS == 200


@functools.lru_cache(maxsize=None)
def _small_nest(dtype, **kw):
    """A 32 px NesT (hd 8 and 16), built once a dtype and kind: the tests only
    run it."""
    return nest.Nest(**SMALL, dtype=dtype, device="cpu", seed=2, **kw)


@pytest.mark.parametrize("case", ["cpu", "fp32", "grad", "capture"])
def test_the_einsum_path_keeps_its_blocks(case):
    """On the CPU every condition keeps the einsum path: ``encoder.blocks``
    counts as before, ``encoder.blocks_fused`` reads 0 in every span, no
    kernel launch."""
    enc = _small_nest(torch.float32 if case == "fp32" else torch.bfloat16)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    before = tb.block_attention.launches
    trace.enable()
    with torch.set_grad_enabled(case == "grad"):
        if case == "capture":
            with capture_attention() as found:
                enc(x)
            assert sum(key == "attn" for _, key, _ in found) == 4
        else:
            enc(x)
    snap = trace.reset()
    attn = snap["spans"]["encoder.block_attn"]
    assert [s["counts"]["encoder.blocks"] for s in attn] == [32, 8, 2, 2]
    assert [s["counts"]["encoder.blocks_fused"] for s in attn] == [0, 0, 0, 0]
    assert snap["counters"]["block_attention.launches"] == before


@pytest.mark.parametrize("kw,fused", [({}, [32, 8, 2, 2]), ({"rel_bias": True}, [0, 0, 0, 0]),
                                      ({"gpsa_levels": 2}, [0, 0, 2, 2])])
def test_a_fused_forward_equals_the_einsum_forward(monkeypatch, kw, fused):
    """With the route forced on the CPU the standard kind's layers run qkv,
    the op's plain version and proj over its permuted columns: the same
    features as the einsum path, their blocks counted as fused under each
    span. The rel kind and the GPSA levels keep the einsum path."""
    enc = _small_nest(torch.float32, **kw)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    route = nest.block_route
    with torch.no_grad():
        want = enc(x)
        monkeypatch.setattr(nest, "block_route",
                            lambda device, dtype, tokens, hd, dropout, kind: route(
                                CUDA, torch.bfloat16, 196, 32, dropout, kind))
        trace.enable()
        got = enc(x)
    snap = trace.reset()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    attn = snap["spans"]["encoder.block_attn"]
    assert [s["counts"]["encoder.blocks_fused"] for s in attn] == fused
    assert [s["counts"]["encoder.blocks"] for s in attn] == [32, 8, 2, 2]


def test_nest_t_on_the_meta_device_counts_no_fused_block():
    """The registry's NesT-T in bf16 on the meta device: 48 blocks an image
    under the spans, none fused (the route takes CUDA tensors only)."""
    with torch.device("meta"):
        enc = models.make("nest_tiny_s196_224", dtype=torch.bfloat16, device="meta")
    trace.enable()
    with torch.no_grad():
        enc(torch.empty(2, 224, 224, 3, device="meta"))
    snap = trace.reset()
    assert snap["counters"]["encoder.blocks"] == 48 * 2
    assert snap["counters"]["encoder.blocks_fused"] == 0
    assert len(snap["spans"]["encoder.block_attn"]) == 12


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_blocks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()


@pytest.mark.parametrize("name", sorted(n for n in CHIP_SMOKE.ZOO_SHAPES if n.startswith("nest")))
def test_zoo_forwards_take_the_kernel_where_chip_smoke_counts(name, monkeypatch):
    """Each NesT of ``chip_smoke.py`` phase 20's zoo, in bf16 without
    autograd on the meta device, with each layer's route asked as on the
    card: the layers the route sends to the kernel are the launches phase 20
    expects (``ZOO_BLOCK_LAUNCHES``, 0 where unlisted)."""
    route, taken = nest.block_route, []

    def on_card(device, *a):
        taken.append(route(CUDA, *a))
        return False

    monkeypatch.setattr(nest, "block_route", on_card)
    size = CHIP_SMOKE.ZOO_SHAPES[name][0]
    with torch.device("meta"):
        enc = models.make(name, dtype=torch.bfloat16, device="meta")
    with torch.no_grad():
        enc(torch.empty(1, size, size, 3, device="meta"))
    assert sum(taken) == CHIP_SMOKE.ZOO_BLOCK_LAUNCHES.get(name, 0)


def test_op_registration_on_the_cpu():
    """The op's schema, fake implementation and CPU implementation agree
    (``torch.library.opcheck``)."""
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, 4, 25, 3 * 64, generator=gen).to(torch.bfloat16)
    torch.library.opcheck(tb.block_attention_op, (qkv, 2, 32 ** -0.5))


@pytest.mark.parametrize("shape,heads", [((2, 16, 196, 288), 3), ((3, 1, 196, 1152), 12),
                                         ((1, 16, 25, 384), 4), ((2, 1, 100, 1536), 16)])
def test_fake_kernel_shapes(shape, heads):
    """The fake implementation gives (B, T, N, C) in the input's dtype from
    (B, T, N, 3C), without computing."""
    with FakeTensorMode():
        qkv = torch.empty(shape, dtype=torch.bfloat16)
        out = tb.block_attention_op(qkv, heads, 32 ** -0.5)
        assert tuple(out.shape) == shape[:3] + (shape[3] // 3,)
        assert out.dtype == torch.bfloat16


def test_op_refuses_what_the_kernel_cannot_take():
    qkv = torch.zeros(1, 4, 196, 3 * 96, dtype=torch.bfloat16)
    out = torch.empty(1, 4, 196, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head width"):
        tb._check(qkv.float(), out.float(), 3)
    with pytest.raises(ValueError, match="head width"):
        tb._check(qkv, out, 2)
    with pytest.raises(ValueError, match="at most 200"):
        tb._check(torch.zeros(1, 1, 256, 96, dtype=torch.bfloat16),
                  torch.empty(1, 1, 256, 32, dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="out must be"):
        tb._check(qkv, out[..., :64], 3)
    with pytest.raises(ValueError, match="contiguous"):
        tb._check(qkv, torch.empty(1, 4, 96, 196, dtype=torch.bfloat16).transpose(2, 3), 3)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tb.block_attention(qkv.to("meta"), 3, 1.0)
