"""``core/trace.py``: the port's spans and counters on the CPU.

With tracing off a span does nothing; under a ``torch.profiler`` session the
spans of an episodic eval, a SUN-D eval and each trainer's step appear in
the Chrome trace as ``user_annotation`` events, nested as the layers nest,
and in ``snapshot()`` with their parents; counters add to the innermost
span; the sync-warning handler counts and restores the warning filters; the
kernels' launch counters stay where they are and count with tracing off; and
no span reaches an exported program."""

import json
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fewshot_vit_tpu_torch.core import trace
from fewshot_vit_tpu_torch.data.datasets import synthetic
from fewshot_vit_tpu_torch.eval import export
from fewshot_vit_tpu_torch.eval.emd_eval import evaluate_emd
from fewshot_vit_tpu_torch.eval.episodic import evaluate
from fewshot_vit_tpu_torch.heads.deepemd import DeepEMD
from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline
from fewshot_vit_tpu_torch.heads.token_label import TokenLabel
from fewshot_vit_tpu_torch.kernels import attention, sinkhorn
from fewshot_vit_tpu_torch.models.visformer import Visformer
from fewshot_vit_tpu_torch.train.meta_tune_emd import make_patch_fn
from fewshot_vit_tpu_torch.train.optim import make_optimizer
from fewshot_vit_tpu_torch.train.state import TrainState
from fewshot_vit_tpu_torch.train.steps import (
    make_meta_tune_step,
    make_pretrain_step,
    make_sun_step,
)

torch.set_num_threads(1)
TINY = dict(img_size=32, init_channels=8, embed_dim=48, depth=(1, 1, 2), num_heads=2)
ENCODER = ["encoder", "encoder.stem", "encoder.stage1", "encoder.stage2", "encoder.stage3"]
WAY, SHOT, QUERY = 3, 1, 2


@pytest.fixture(autouse=True)
def fresh_registry():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _encoder(seed=0):
    return Visformer(**TINY, device="cpu", seed=seed)


def _dataset():
    return synthetic(n_classes=4, n_per_class=6, image_size=32, seed=1)


def _chrome(prof_fn, tmp_path):
    """``prof_fn()`` under a CPU profiler -> its Chrome trace's user_annotation
    events, and the snapshot."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        prof_fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"], trace.snapshot()


def _names(notes):
    out = {}
    for e in notes:
        out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def _within(notes, child: str, parent: str) -> bool:
    """Every ``child`` annotation lies inside some ``parent`` annotation."""
    outer = [(e["ts"], e["ts"] + e["dur"]) for e in notes if e["name"] == parent]
    return all(any(s <= e["ts"] and e["ts"] + e["dur"] <= t for s, t in outer)
               for e in notes if e["name"] == child)


def _parents(snap, name):
    return [s["parent"] for s in snap["spans"][name]]


def test_span_off_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span with tracing off entered record_function")

    monkeypatch.setattr(trace, "record_function", refuse)
    monkeypatch.setattr(trace, "_cuda_event", refuse)
    monkeypatch.setattr(trace, "_HostEvent", refuse)
    head = MetaBaseline(_encoder()).eval()
    evaluate(head, _dataset(), n_episodes=2, way=WAY, shot=SHOT, query=QUERY, ep_per_batch=1,
             device="cpu")
    with trace.span("outer"):
        trace.count("x")
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["counters"]["x"] == 1


def test_evaluate_spans_nest_in_the_profiler_trace(tmp_path):
    head = MetaBaseline(_encoder()).eval()
    notes, snap = _chrome(lambda: evaluate(head, _dataset(), n_episodes=4, way=WAY, shot=SHOT,
                                           query=QUERY, ep_per_batch=2, device="cpu"), tmp_path)
    n = 2  # batches
    assert _names(notes) == {"eval.sample": 1, "eval.batch": n, "eval.inputs": n,
                             "head.logits": n, "eval.accuracy": n, "eval.collect": 1,
                             **{e: n for e in ENCODER}}
    for child, parent in (("eval.inputs", "eval.batch"), ("encoder", "eval.batch"),
                          ("head.logits", "eval.batch"), ("eval.accuracy", "eval.batch"),
                          ("encoder.stage2", "encoder")):
        assert _within(notes, child, parent), (child, parent)
        assert _parents(snap, child) == [parent] * n
    assert _parents(snap, "eval.batch") == [None] * n
    assert [s["parent_index"] for s in snap["spans"]["encoder"]] == [0, 1]
    for s in snap["spans"]["eval.batch"]:
        assert s["end_ns"] > s["start_ns"] and s["device_ms"] > 0 and s["host_ms"] > 0


@pytest.mark.parametrize("shot", [1, 2])
def test_emd_eval_spans(shot, tmp_path):
    """SUN-D: the patches inside the inputs, the solver inside the head; SFC
    (shot > 1) is one opaque span whose inner matchings are not spans."""
    head = DeepEMD(_encoder(), solver="sinkhorn_detached", solver_iters=5).eval()
    ds = _dataset()
    notes, snap = _chrome(lambda: evaluate_emd(
        head, ds, way=WAY, shot=shot, query=QUERY, n_episodes=2, ep_per_batch=1, image_size=32,
        sfc_kw={"steps": 2, "batch_size": 2}, device="cpu"), tmp_path)
    n = 2
    want = {"eval.sample": 1, "eval.batch": n, "eval.inputs": n, "eval.patches": n,
            "emd.head": n, "emd.solver": n, "eval.accuracy": n, "eval.collect": 1,
            **{e: n for e in ENCODER}}
    if shot > 1:
        want["emd.sfc"] = n
    assert _names(notes) == want
    assert _within(notes, "eval.patches", "eval.inputs")
    assert _within(notes, "emd.solver", "emd.head")
    assert _parents(snap, "emd.solver") == ["emd.head"] * n
    assert _parents(snap, "eval.patches") == ["eval.inputs"] * n
    assert _parents(snap, "encoder") == ["eval.batch"] * n


def _sun_step():
    n_cls = 4
    student = TokenLabel(_encoder(0), n_cls)
    teacher = TokenLabel(_encoder(1), n_cls).requires_grad_(False)
    state = TrainState(student, make_optimizer(student.parameters(), "adamw", lr=1e-3))
    ds = _dataset()
    imgs = torch.from_numpy(ds.images[:4])
    step = make_sun_step(soft_k=2, bg_tokens=1, mean=ds.mean, std=ds.std)
    return lambda: step(state, teacher, imgs, imgs, torch.from_numpy(ds.labels[:4]), (5, 1, 0))


def _pretrain_step():
    ds = _dataset()
    model = TokenLabel(_encoder(), 4)
    model.forward = lambda x, **k: TokenLabel.forward(model, x, **k)[1]
    state = TrainState(model, make_optimizer(model.parameters(), "sgd", lr=0.1))
    step = make_pretrain_step(mean=ds.mean, std=ds.std)
    return lambda: step(state, torch.from_numpy(ds.images[:4]),
                        torch.from_numpy(ds.labels[:4]), (5, 1, 0))


def _meta_tune_step():
    ds = _dataset()
    head = MetaBaseline(_encoder())
    state = TrainState(head, make_optimizer(head.parameters(), "sgd", lr=0.1))
    step = make_meta_tune_step(WAY, QUERY, 1, mean=ds.mean, std=ds.std)
    xs = torch.from_numpy(ds.images[:WAY]).reshape(1, WAY, 1, 32, 32, 3)
    xq = torch.from_numpy(ds.images[4:4 + WAY * QUERY]).reshape(1, WAY * QUERY, 32, 32, 3)
    return lambda: step(state, xs, xq, (5, 1, 0))


@pytest.mark.parametrize("make", [_sun_step, _pretrain_step, _meta_tune_step],
                         ids=["sun", "pretrain", "meta_tune"])
def test_training_step_spans(make, tmp_path):
    step = make()
    notes, snap = _chrome(step, tmp_path)
    inner = ["train.augment", "train.student", "train.backward", "train.grad_sync",
             "train.optimizer"]
    names = _names(notes)
    teacher = make is _sun_step
    assert {k: names[k] for k in ["train.step"] + inner} == {k: 1 for k in ["train.step"] + inner}
    assert names.get("train.teacher", 0) == int(teacher)
    assert names["encoder"] == 1 + int(teacher)  # the teacher's forward and the student's
    for name in inner + (["train.teacher"] if teacher else []):
        assert _within(notes, name, "train.step") and _parents(snap, name) == ["train.step"]
    assert sorted(_parents(snap, "encoder")) == sorted(
        ["train.student"] + (["train.teacher"] if teacher else []))


def test_counters_add_to_the_innermost_span_and_the_total():
    trace.enable()
    with trace.span("outer"):
        trace.count("c", 2)
        with trace.span("inner"):
            trace.count("c")
            trace.count("d", 5)
    trace.count("c")  # no span open: the total only
    snap = trace.reset()
    assert snap["spans"]["inner"][0]["counts"] == {"c": 1, "d": 5}
    assert snap["spans"]["outer"][0]["counts"] == {"c": 3, "d": 5}  # its inner span's too
    assert snap["spans"]["inner"][0]["parent"] == "outer"
    assert snap["counters"]["c"] == 4 and snap["counters"]["d"] == 5
    assert trace.snapshot()["spans"] == {} and "c" not in trace.snapshot()["counters"]


def test_decorator_and_opaque_span():
    @trace.span("work")
    def work(x):
        with trace.span("hidden"):
            return x + 1

    trace.enable()
    assert work(1) == 2 and work.__name__ == "work"
    with trace.span("loop", opaque=True):
        work(2)
    snap = trace.snapshot()
    assert len(snap["spans"]["work"]) == 1 and len(snap["spans"]["hidden"]) == 1
    assert len(snap["spans"]["loop"]) == 1


def test_span_cap_drops_the_rest(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    trace.enable()
    for _ in range(5):
        with trace.span("s"):
            pass
    snap = trace.snapshot()
    assert len(snap["spans"]["s"]) == 3 and snap["dropped"] == {"s": 2}


def test_sync_warnings_are_counted_and_the_filters_restored():
    filters, shown = list(warnings.filters), warnings.showwarning
    trace.enable()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with trace.span("batch"):
            with trace.span("inputs"):
                for _ in range(3):
                    warnings.warn("called a synchronizing CUDA operation", UserWarning)
            warnings.warn("something else", UserWarning)
    snap = trace.snapshot()
    assert snap["spans"]["inputs"][0]["counts"] == {trace.SYNC_COUNTER: 3}
    assert snap["spans"]["batch"][0]["counts"] == {trace.SYNC_COUNTER: 3}
    assert snap["counters"][trace.SYNC_COUNTER] == 3
    assert [str(w.message) for w in seen] == ["something else"]  # others pass through
    assert warnings.filters == filters and warnings.showwarning is shown
    warnings.warn("called a synchronizing CUDA operation outside", UserWarning)
    assert trace.snapshot()["counters"][trace.SYNC_COUNTER] == 3


def _stub_launches(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(
        cuda_stream=0))
    monkeypatch.setattr(attention, "_mhsa_forward", lambda: (lambda *a: 0))
    monkeypatch.setattr(sinkhorn, "_sinkhorn_forward", lambda: (lambda *a: 0))


def test_route_launches_count_with_tracing_off_and_are_in_the_snapshot(monkeypatch):
    _stub_launches(monkeypatch)
    q = torch.zeros(1, 2, 8, 16)
    before = trace.counters()
    attention._launch(q, q, q, torch.empty_like(q), 1.0, "general")
    cost = torch.zeros(2, 5, 5)
    sinkhorn._launch(cost, torch.ones(2, 5), torch.ones(2, 5), torch.empty_like(cost), 0.05, 10,
                     None)
    after = trace.counters()
    assert after["fused_mhsa.route_launches.general"] == before[
        "fused_mhsa.route_launches.general"] + 1
    assert after["sinkhorn_pallas.route_launches.packed"] == before[
        "sinkhorn_pallas.route_launches.packed"] + 1
    assert trace.snapshot()["spans"] == {}
    # the counters are read where they live, also after their owners replace them
    monkeypatch.setattr(attention.fused_mhsa, "route_launches", {r: 7 for r in attention.ROUTES})
    assert trace.counters()["fused_mhsa.route_launches.tensor_core"] == 7
    assert "exact_flows.host_seconds" in trace.counters()


def _scorer():
    head = MetaBaseline(_encoder()).eval()
    return lambda: export.export_episode_scorer(head, way=WAY, shot=SHOT, query=QUERY,
                                                image_size=32, platforms=("cpu",))


def _emd_scorer():
    head = DeepEMD(_encoder(), solver="sinkhorn_pallas", solver_iters=5).eval()
    return lambda: export.export_emd_episode_scorer(
        head, way=WAY, shot=SHOT, query=QUERY, image_size=32, platforms=("cpu",),
        patch_fn=make_patch_fn("grid", [2, 3], 2.0, 32, train=False))


@pytest.mark.parametrize("make", [_scorer, _emd_scorer], ids=["meta_baseline", "deepemd"])
def test_spans_never_reach_an_exported_program(make):
    do = make()
    plain = do()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = do()
    assert str(traced.graph) == str(plain.graph)
    assert "record_function" not in str(traced.graph) and "profiler" not in str(traced.graph)
    assert trace.snapshot()["spans"] == {}
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randint(0, 256, x.shape, generator=gen, dtype=torch.uint8)
          for x in traced.example_inputs[0]]
    with torch.no_grad():
        np.testing.assert_array_equal(traced.module()(*xs).numpy(), plain.module()(*xs).numpy())
