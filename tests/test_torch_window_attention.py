"""Swin's window attention op (``kernels/window.py``) on the CPU: its plain
implementation, the addressing the CUDA kernel does (gather indices for the
shift, region ids from the rolled coordinates, the bias by relative offset),
held to the einsum path it replaces (roll, partition, ``WindowAttention``,
reverse, roll back) on the same block; and the route a block takes."""

import functools
import math

import pytest
import torch

from fewshot_vit_tpu_torch.core import trace
from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.kernels import window as tw
from fewshot_vit_tpu_torch.models import swin
from fewshot_vit_tpu_torch.models.common import capture_attention, init_weights

# Swin-T's stage widths at 224 px, window 7, one image: (grid, channels,
# heads); 7 is the clamped last stage (one window, no shift)
STAGES = [(56, 96, 3), (28, 192, 6), (14, 384, 12)]
# swin_nano's stages at 96 px, hd 32 as Swin-T's, windows of 6 and the
# clamped 3: (grid, channels, heads, shift, window); the shifted window-6
# cases are not nano's blocks (one a stage there) but the kernel takes them
NANO_STAGES = [(24, 64, 2, 0, 6), (24, 64, 2, 3, 6), (12, 128, 4, 3, 6), (6, 256, 8, 0, 6),
               (3, 512, 16, 0, 3)]


@pytest.fixture(autouse=True)
def fresh_registry():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _block(res, c, heads, shift, seed, dtype=torch.float32, window=7):
    """A Swin block with the benchmark's scales: linear kernels at
    1 / sqrt(fan_in), the bias table at std 1, so the bias shows."""
    blk = swin.SwinBlock(c, res, heads, window, shift, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    init_weights(blk, gen)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.copy_(torch.randn(p.shape, generator=gen))
            elif p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1]))
    return blk.eval()


def _grid(res, c, seed, dtype=torch.float32):
    return torch.randn(1, res, res, c, generator=torch.Generator().manual_seed(seed)).to(dtype)


@pytest.mark.parametrize("res,c,heads,shift,window", [
    pytest.param(res, c, heads, s, 7, id=f"{res}-{c}-{heads}-{s}")
    for res, c, heads in STAGES for s in (0, 3)] + [pytest.param(7, 768, 24, 0, 7, id="7-768-24-0")]
    + [pytest.param(*case, id="{}-{}-{}-{}-window{}".format(*case)) for case in NANO_STAGES])
def test_op_matches_the_einsum_path(res, c, heads, shift, window):
    """fp32: the two differ only in the order of summation (one GEMM on the
    grid against one on the windows, einsums over other index orders)."""
    blk = _block(res, c, heads, shift, res + shift, window=window)
    assert (blk.window, blk.shift) == (window, shift)
    y = _grid(res, c, res)
    with torch.no_grad():
        want = blk.einsum_attention(y)
        got = blk.attn.fused(y, window, shift)
    assert got.shape == want.shape == (1, res, res, c)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_op_matches_the_einsum_path_in_bf16():
    """bf16: the op keeps scores, bias and softmax in fp32 where the einsum
    path rounds them, so the two differ by bf16 roundings of outputs of
    order 1."""
    blk = _block(14, 384, 12, 3, 9, torch.bfloat16)
    y = _grid(14, 384, 9, torch.bfloat16)
    with torch.no_grad():
        want = blk.einsum_attention(y).float()
        got = blk.attn.fused(y, 7, 3).float()
    assert (got - want).abs().max().item() <= 0.05
    assert (got - want).abs().mean().item() <= 0.005


# faults of the addressing: (src, rel, region) -> what a wrong kernel would use
FAULTS = {
    "no_mask": lambda src, rel, region: (src, rel, torch.zeros_like(region)),
    "wrong_region": lambda src, rel, region: (src, rel, region - region % 3),  # rows only
    "transposed_bias": lambda src, rel, region: (src, rel.T, region),
}


@pytest.mark.parametrize("broken", ["no_shift"] + list(FAULTS))
def test_the_comparison_sees_a_wrong_address(broken, monkeypatch):
    """Each fault moves the op's output far beyond the tolerance above on
    Swin-T's stage 2: the comparison holds the shift, the mask, the region
    ids and the bias offsets."""
    blk = _block(28, 192, 6, 3, 5)
    y = _grid(28, 192, 5)
    if broken in FAULTS:
        right = tw.window_addressing
        monkeypatch.setattr(tw, "window_addressing", lambda *a: FAULTS[broken](*right(*a)))
    with torch.no_grad():
        got = blk.attn.fused(y, 7, 0 if broken == "no_shift" else 3)
        want = blk.einsum_attention(y)
    assert (got - want).abs().max().item() > 1e-2


def test_addressing_is_the_roll_and_the_partition():
    """``src`` lists the grid positions that roll by -s and partition put in
    each window; the regions are ``shifted_window_mask``'s: at Swin-T's
    window 7 and at swin_nano's window 6 (bias table 11 x 11)."""
    for res, ws, s in ((14, 7, 3), (24, 6, 3), (12, 6, 3)):
        src, rel, region = tw.window_addressing(res, ws, s)
        grid = torch.arange(res * res).reshape(1, res, res, 1)
        want = swin.window_partition(torch.roll(grid, (-s, -s), dims=(1, 2)), ws)[..., 0]
        assert torch.equal(src, want)
        assert torch.equal(rel, torch.from_numpy(swin.relative_position_index(ws)).long())
        mask = torch.from_numpy(swin.shifted_window_mask(res, res, ws, s))
        assert torch.equal(mask != 0, region[:, :, None] != region[:, None, :])
        assert (tw.window_addressing(res, ws, 0)[2] == 0).all()


CUDA = torch.device("cuda")


@pytest.mark.parametrize("case", ["kernel", "cpu", "fp32", "grad", "capture", "dropout",
                                  "window_8x9", "head_dim_36"])
def test_window_route(case):
    """The kernel's route only on CUDA tensors, in bf16, without autograd
    or capture, with attention dropout off, for windows of at most 64 tokens
    and the compiled head width; each condition alone keeps the einsum
    path."""
    device = torch.device("cpu") if case == "cpu" else CUDA
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    tokens = 72 if case == "window_8x9" else 49
    hd = 36 if case == "head_dim_36" else 32
    with torch.set_grad_enabled(case == "grad"):
        if case == "capture":
            with capture_attention():
                taken = swin.window_route(device, dtype, tokens, hd, False)
        else:
            taken = swin.window_route(device, dtype, tokens, hd, case == "dropout")
    assert taken == (case == "kernel")


@functools.lru_cache(maxsize=None)
def _small_swin(dtype):
    """Swin-T's widths at 56 px (a 14 x 14 grid of four windows, then one
    clamped window), built once a dtype: the tests only run it."""
    return models.make("swin_tiny_patch4_window7_224", img_size=56, depths=(2, 2),
                       num_heads=(3, 6), dtype=dtype, device="cpu", seed=2)


@pytest.mark.parametrize("case", ["cpu", "fp32", "grad", "capture"])
def test_the_einsum_path_keeps_its_blocks(case):
    """On the CPU every condition keeps the einsum path: ``encoder.windows``
    counts as before, ``encoder.windows_fused`` stays 0, no kernel launch."""
    enc = _small_swin(torch.float32 if case == "fp32" else torch.bfloat16)
    x = torch.randn(2, 56, 56, 3, generator=torch.Generator().manual_seed(1))
    before = tw.window_attention.launches
    trace.enable()
    with torch.set_grad_enabled(case == "grad"):
        if case == "capture":
            with capture_attention() as found:
                enc(x)
            assert sum(key == "attn" for _, key, _ in found) == 4
        else:
            enc(x)
    snap = trace.reset()
    assert snap["counters"]["encoder.windows"] == 2 * (4 * 2 + 1 * 2)
    assert snap["counters"].get("encoder.windows_fused", 0) == 0
    assert snap["counters"]["window_attention.launches"] == before


def test_a_fused_forward_equals_the_einsum_forward(monkeypatch):
    """With the route forced on the CPU the blocks run qkv, the op's plain
    version and proj on the un-rolled grid: the same features as the einsum
    path, every window counted as fused, and the traced forward of Swin-T's
    registry entry on the meta device still counts 186 windows an image."""
    enc = _small_swin(torch.float32)
    x = torch.randn(2, 56, 56, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = enc(x)
        monkeypatch.setattr(swin, "window_route", lambda *a: True)
        trace.enable()
        got = enc(x)
    snap = trace.reset()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    attn = snap["spans"]["encoder.window_attn"]
    assert len(attn) == 4
    assert [s["counts"]["encoder.windows_fused"] for s in attn] == [8, 8, 2, 2]
    assert [s["counts"]["encoder.windows"] for s in attn] == [8, 8, 2, 2]
    monkeypatch.undo()
    with torch.device("meta"):
        tiny = models.make("swin_tiny_patch4_window7_224", dtype=torch.bfloat16, device="meta")
    trace.enable()
    with torch.no_grad():
        tiny(torch.empty(2, 224, 224, 3, device="meta"))
    snap = trace.reset()
    assert snap["counters"]["encoder.windows"] == 186 * 2
    assert snap["counters"].get("encoder.windows_fused", 0) == 0


def test_op_refuses_what_the_kernel_cannot_take():
    qkv = torch.zeros(1, 14, 14, 3 * 96, dtype=torch.bfloat16)
    table = torch.zeros(169, 3)
    with pytest.raises(ValueError, match="float32"):
        tw._check(qkv, table.double(), torch.empty(1, 14, 14, 96, dtype=torch.bfloat16), 3, 7, 3)
    with pytest.raises(ValueError, match="tile"):
        tw._check(qkv, table, torch.empty(1, 14, 14, 96, dtype=torch.bfloat16), 3, 7, 7)
    with pytest.raises(ValueError, match="head width"):
        tw._check(qkv.float(), table, torch.empty(1, 14, 14, 96), 3, 7, 3)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tw.window_attention(qkv.to("meta"), table, 3, 7, 3, 1.0)


def test_op_registration_on_the_cpu():
    """The op's schema, fake implementation and CPU implementation agree
    (``torch.library.opcheck``), shifted and not."""
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn(1, 14, 14, 3 * 64, generator=gen).to(torch.bfloat16)
    table = torch.randn(169, 2, generator=gen)
    for shift in (0, 3):
        torch.library.opcheck(tw.window_attention_op, (qkv, table, 2, 7, shift, 32 ** -0.5))
