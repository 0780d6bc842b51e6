"""The LayerNorm op (``kernels/layer_norm.py``) on the CPU: its plain version
is the fp32 line ``models/common.py::LayerNorm`` always ran, bit for bit;
the route a call takes (``layer_norm_route``), each condition falsified
alone; the span and counters a traced forward records; Swin forwards on
the CPU unchanged; and the benchmark's three LayerNorm readers on spans
made here, on Swin-T's widths and on a tiny traced run of the Swin cell."""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark.core import Run, execute, read_metric
from benchmark.roofline import HBM_BYTES_PER_S
from benchmark.tests.tiny import tiny
from fewshot_vit_tpu_torch.core import trace
from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.kernels import layer_norm as tln
from fewshot_vit_tpu_torch.models import common
from fewshot_vit_tpu_torch.models.common import LayerNorm

ROOT = Path(__file__).resolve().parent.parent
SWIN_CELL = "sunm_eval_swin_tiny_224"
READERS = ("layer_norm_fused_pct.eval", "layer_norm_ms.eval", "layer_norm_roofline_pct.eval")
# Swin-T's LayerNorm widths: stages 1 to 4, the PatchMergings' 4C among them
WIDTHS = (96, 192, 384, 768, 1536)
# (rows an image, width) of a Swin-T forward's 29 LayerNorms at 224 px, in
# order: the patch embedding's and stage 1's, merge 1's, stage 2's, merge
# 2's, stage 3's, merge 3's, stage 4's and the final norm
SWIN_T_NORMS = (((3136, 96),) * 5 + ((784, 384),) + ((784, 192),) * 4 + ((196, 768),)
                + ((196, 384),) * 12 + ((49, 1536),) + ((49, 768),) * 5)
ELEMS_PER_IMAGE = 3725568  # the 29 LayerNorms of a Swin-T forward at 224 px


@pytest.fixture(autouse=True)
def fresh_registry():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _inputs(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(shape, generator=gen) + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(shape[-1], generator=gen)
    b = 0.1 * torch.randn(shape[-1], generator=gen)
    return x, w, b


def _norm(c, dtype, w, b):
    norm = LayerNorm(c, 1e-5, dtype)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    return norm


def _fp32_line(self, x):
    """``LayerNorm.forward`` before the kernel's route: the fp32 line."""
    y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
    return y.to(self.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", WIDTHS + (100,))
def test_the_plain_version_is_the_fp32_line(dtype, c):
    """``layer_norm_reference``, the op's CPU implementation and the module
    each equal the fp32 line bit for bit, at Swin-T's widths and at one the
    kernel does not take."""
    x, w, b = _inputs((3, 17, c), dtype, c)
    norm = _norm(c, dtype, w, b)
    want = _fp32_line(norm, x)
    assert want.dtype == dtype
    assert torch.equal(tln.layer_norm_reference(x, w, b, 1e-5, dtype), want)
    assert torch.equal(tln.layer_norm(x, w, b, 1e-5), want)
    with torch.no_grad():
        assert torch.equal(norm(x), want)


class _OnCard:
    """A CPU tensor as the route sees a CUDA one: its device reads cuda."""

    device = torch.device("cuda")

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("case", ["kernel", "width_8", "width_2048", "cpu", "fp32_in", "fp32_out",
                                  "grad", "strided", "unaligned", "width_100", "width_2056"])
def test_layer_norm_route(case):
    """The kernel only for CUDA, bf16 in and out, no gradient recorded, rows
    packed at stride C from a 16-byte aligned start, and a width that is a
    multiple of 8 up to 2,048; each condition falsified alone keeps the fp32
    line."""
    c = {"width_8": 8, "width_2048": 2048, "width_100": 100, "width_2056": 2056}.get(case, 96)
    dtype = torch.float32 if case == "fp32_in" else torch.bfloat16
    x = torch.zeros(4, 6, c, dtype=dtype)
    if case == "strided":
        x = x.transpose(0, 1)
    if case == "unaligned":  # one element in: rows 2 bytes off a 16-byte boundary
        x = torch.zeros(4 * 6 * c + 1, dtype=dtype)[1:].view(4, 6, c)
    seen = x if case == "cpu" else _OnCard(x)
    out = torch.float32 if case == "fp32_out" else torch.bfloat16
    with torch.set_grad_enabled(case == "grad"):
        taken = common.layer_norm_route(seen, out)
    assert taken == (case in ("kernel", "width_8", "width_2048"))


@pytest.mark.parametrize("fused", [False, True])
def test_span_and_counters_under_a_profiler(fused, monkeypatch):
    """Under a profiler session every call records an ``encoder.norm`` span
    with its elements in ``encoder.norm_elems``, and those the route sends to
    the op in ``encoder.norm_elems_fused`` too; the op's CPU implementation
    is the plain version, so the output is the fp32 line's and nothing is
    launched. Without a session no span is kept."""
    x, w, b = _inputs((2, 49, 96), torch.bfloat16, 1)
    norm = _norm(96, torch.bfloat16, w, b)
    want = _fp32_line(norm, x)
    if fused:
        monkeypatch.setattr(common, "layer_norm_route", lambda x, dtype: True)
    launches = tln.layer_norm.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            got = [norm(x) for _ in range(3)]
    snap = trace.reset()
    counts = {"encoder.norm_elems": x.numel()}
    if fused:
        counts["encoder.norm_elems_fused"] = x.numel()
    assert [s["counts"] for s in snap["spans"]["encoder.norm"]] == [counts] * 3
    assert snap["counters"]["encoder.norm_elems"] == 3 * x.numel()
    assert snap["counters"]["layer_norm.launches"] == launches
    assert all(torch.equal(g, want) for g in got)
    with torch.no_grad():
        norm(x)
    assert trace.snapshot()["spans"] == {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_cpu_swin_forward_is_unchanged(dtype, monkeypatch):
    """A small Swin at Swin-T's widths gives the features it gave with the
    fp32 line in every LayerNorm, bit for bit; its 11 LayerNorms record their
    spans and elements, none fused."""
    enc = models.make("swin_tiny_patch4_window7_224", img_size=56, depths=(2, 2),
                      num_heads=(3, 6), dtype=dtype, device="cpu", seed=2)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, LayerNorm):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))
    x = torch.randn(2, 56, 56, 3, generator=gen)
    trace.enable()
    with torch.no_grad():
        got = enc(x)
    snap = trace.reset()
    monkeypatch.setattr(LayerNorm, "forward", _fp32_line)
    with torch.no_grad():
        want = enc(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(snap["spans"]["encoder.norm"]) == 11
    # stem, 4 stage-1 norms, the merge: 14 x 14 x 96 each; 4 stage-2 norms, the final: 7 x 7 x 192
    assert snap["counters"]["encoder.norm_elems"] == 2 * (6 * 196 * 96 + 5 * 49 * 192)
    assert snap["counters"].get("encoder.norm_elems_fused", 0) == 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_zoo", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()


@pytest.mark.parametrize("name", sorted(CHIP_SMOKE.ZOO_SHAPES))
def test_zoo_forwards_take_the_kernel_where_chip_smoke_counts(name, monkeypatch):
    """Each of ``chip_smoke.py`` phase 20's zoo encoders, in bf16 without
    autograd on the CPU, with each LayerNorm's input shown to the route as
    on the card: the calls the route sends to the kernel are the launches
    phase 20 expects (``ZOO_LAYER_NORM_LAUNCHES``, 0 where unlisted)."""
    route, taken = common.layer_norm_route, []

    def on_card(x, dtype):
        taken.append(route(_OnCard(x), dtype))
        return False

    monkeypatch.setattr(common, "layer_norm_route", on_card)
    size = CHIP_SMOKE.ZOO_SHAPES[name][0]
    enc = models.make(name, dtype=torch.bfloat16, device="cpu", seed=0)
    with torch.inference_mode():
        enc(torch.zeros(1, size, size, 3))
    assert sum(taken) == CHIP_SMOKE.ZOO_LAYER_NORM_LAUNCHES.get(name, 0)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"layer_norm_reader_{name}", ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_swin_t_forward_makes_its_29_norms():
    """The traced forward of Swin-T's registry entry on the meta device makes
    29 LayerNorm calls, of the widths and rows ``SWIN_T_NORMS`` lists, in
    order, and counts 3,725,568 elements an image."""
    seen = []
    with torch.device("meta"):
        enc = models.make("swin_tiny_patch4_window7_224", dtype=torch.bfloat16, device="meta")
    for m in enc.modules():
        if isinstance(m, LayerNorm):
            m.register_forward_pre_hook(
                lambda mod, args: seen.append((args[0].numel() // 2 // args[0].shape[-1],
                                               args[0].shape[-1])))
    trace.enable()
    with torch.no_grad():
        enc(torch.empty(2, 224, 224, 3, device="meta"))
    snap = trace.reset()
    assert seen == list(SWIN_T_NORMS)
    assert len(snap["spans"]["encoder.norm"]) == 29
    assert sorted({c for _, c in seen}) == list(WIDTHS)
    assert snap["counters"]["encoder.norm_elems"] == 2 * ELEMS_PER_IMAGE


def _swin_t_spans(images, forwards, fused_share, ms_of):
    """The ``encoder.norm`` spans of ``forwards`` Swin-T forwards of
    ``images`` images each, one a LayerNorm call; ``ms_of(elems)`` gives a
    span's device ms."""
    spans = []
    for _ in range(forwards):
        for rows, c in SWIN_T_NORMS:
            n = images * rows * c
            spans.append({"device_ms": ms_of(n), "counts": {
                "encoder.norm_elems": n, "encoder.norm_elems_fused": n * fused_share}})
    return spans


def test_the_readers_on_swin_t_spans(monkeypatch):
    """Two batches of 2,560 images: a kernel at exactly the bound (each
    element read and written once in bf16) reads 100%, twice as slow 50%;
    the fused share is the elements' share; the ms are per ``eval.batch``
    span. A run with no spans, or of another kind, reads nothing."""
    import benchmark.metrics._program_trace as pt

    spans = {"eval.batch": [{"device_ms": 1.0}] * 2}
    monkeypatch.setattr(pt, "_spans", lambda run, kind, name: spans.get(name, [])
                        if kind == run.kind else [])
    run = Run(SWIN_CELL, "eval", "episodes", 1.0, 1.0, 1, 1.0, 1.0, trace=object(),
              extra={"dtype": "bfloat16"})
    assert all(read_metric(name, run) is None for name in READERS)
    bound = lambda n: 4 * n / HBM_BYTES_PER_S * 1e3  # noqa: E731
    spans["encoder.norm"] = _swin_t_spans(2560, 2, 1, bound)
    assert sum(s["counts"]["encoder.norm_elems"] for s in spans["encoder.norm"]) == \
        2 * 2560 * ELEMS_PER_IMAGE
    assert read_metric("layer_norm_roofline_pct.eval", run) == pytest.approx(100.0, rel=1e-9)
    assert read_metric("layer_norm_fused_pct.eval", run) == 100.0
    # 9.54 G elements a batch at 4 bytes each: 11.39 ms a batch at the bound
    assert read_metric("layer_norm_ms.eval", run) == pytest.approx(
        2560 * ELEMS_PER_IMAGE * 4 / HBM_BYTES_PER_S * 1e3, rel=1e-4)
    spans["encoder.norm"] = _swin_t_spans(2560, 2, 0.5, lambda n: 2 * bound(n))
    assert read_metric("layer_norm_roofline_pct.eval", run) == pytest.approx(50.0, rel=1e-9)
    assert read_metric("layer_norm_fused_pct.eval", run) == 50.0
    train = Run(SWIN_CELL, "train", "images", 1.0, 1.0, 1, 1.0, 1.0, trace=object(),
                extra=run.extra)
    assert all(read_metric(name, train) is None for name in READERS)


def test_the_readers_give_nothing_without_the_registry(monkeypatch):
    """A program without the registry (an older parent): None."""
    import fewshot_vit_tpu_torch.core as core

    run = Run(SWIN_CELL, "eval", "episodes", 1.0, 1.0, 1, 1.0, 1.0, trace=object(),
              extra={"dtype": "bfloat16"})
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "fewshot_vit_tpu_torch.core.trace", None)
    assert all(read_metric(name, run) is None for name in READERS)


def test_a_traced_tiny_swin_run_reads_the_layer_norm(monkeypatch):
    """The Swin cell at its tiny size (``benchmark/tests/tiny_sizes``),
    traced on the CPU: every LayerNorm on the fp32 line (0% fused), its ms
    and its roofline share read; an untraced run reads none of them. (This suite's parity tests
    hold JAX in the process, which the harness refuses after a run: that
    check is the benchmark's own tests', so it is set aside here.)"""
    import benchmark.core

    monkeypatch.setattr(benchmark.core, "forbidden_modules", lambda: [])
    out = execute(tiny(SWIN_CELL), torch.device("cpu"), 2**31 + 29, 0.05, True, 0.0)
    assert out["correct"], out["checks"]
    got = {name: out["metrics"][name]["value"] for name in READERS}
    assert got["layer_norm_fused_pct.eval"] == 0.0
    assert got["layer_norm_ms.eval"] > 0
    assert 0 < got["layer_norm_roofline_pct.eval"] <= 100
    out = execute(tiny(SWIN_CELL), torch.device("cpu"), 2**31 + 29, 0.05, False, 0.0)
    assert not set(READERS) & set(out["metrics"])
