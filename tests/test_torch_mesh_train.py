"""The mesh in the trainers: one epoch of each trainer's steps under
``mesh: {data: 2}`` on two gloo ranks (CPU processes with torchrun's
environment, ``torch_port_helpers.launch_ranks``), held to JAX's epoch on the
global batch and to the port's own one-process epoch; SUN-D's task batch
with NaN episodes on either rank held to JAX's ``suffix_keep``; a
``{data: 2, model: 2}`` pretrain step on four ranks with column-parallel
wide layers (``min_features`` 64, JAX's ``test_dp_tp_pretrain_step``) held
to the same step without the model axis and to JAX, its gathered
checkpoint in the unsharded layout; and the four trainer CLIs under
``mesh:`` / ``distributed:``, rank 0 alone writing.

Tolerances, the trainer rules of ``ROADMAP.md`` section 3: per-step loss
and accuracy within 1e-4, parameters within 2e-5, BN statistics within
1e-5, against JAX and against one process; the stem's parameters within
1e-3 of their max-abs. The stem's gradient passes three batch-statistics
BNs, whose ill-conditioning section 3 records (1e-2 of max-abs on the
gradient in fp32); over a mesh the statistics are sums of per-rank sums,
another summation order, and the stem lands up to 2.1e-5 (8e-5 of
max-abs) from JAX and from one process after these epochs (measured),
the rest within 2e-5. The steps with random draws (drop-path, cropaug,
the dual view) have no JAX twin here; their two-rank epoch is held to the
one-process epoch, which draws the same masks and crops (stem measured at
3.3e-4 of max-abs).

Every group of ranks has its own free port and a time limit of 120 s."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fewshot_vit_tpu.core.config import Config as JConfig
from fewshot_vit_tpu.heads import classifier as jc
from fewshot_vit_tpu.heads.deepemd import DeepEMD as JDeepEMD
from fewshot_vit_tpu.heads.meta_baseline import MetaBaseline as JMetaBaseline
from fewshot_vit_tpu.heads.token_label import TokenLabel as JTokenLabel
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.train import loop as jloop
from fewshot_vit_tpu.train import meta_tune_emd as jt
from fewshot_vit_tpu.train.optim import make_optimizer as j_make_optimizer
from fewshot_vit_tpu.train.state import TrainState as JTrainState
from fewshot_vit_tpu_torch.checkpoint import from_flax
from fewshot_vit_tpu_torch.core import rng as t_rng
from fewshot_vit_tpu_torch.data.datasets import synthetic
from fewshot_vit_tpu_torch.data.sampler import EpisodeSampler
from fewshot_vit_tpu_torch.train.loop import batch_indices

from . import test_torch_meta_tune, test_torch_pretrain, test_torch_sun, test_torch_sund_train
from .test_torch_zoo import draw_variables
from .torch_port_helpers import (
    launch_ranks,
    numpy_tree,
    rank_outputs,
    run_step_case,
    wait_ranks,
)

torch.set_num_threads(1)
TINY = dict(img_size=32, init_channels=8, embed_dim=48, depth=(1, 1, 1), num_heads=6)
# JAX's test_dp_tp_pretrain_step geometry
TP_ENC = dict(img_size=32, init_channels=16, embed_dim=64, depth=(1, 1, 1), num_heads=4,
              attn_stage="011", spatial_conv="100")
LR, WD = 0.05, 5e-4
SUN_KW = dict(soft_k=3, bg_tokens=2, token_weight=0.5)
WAY, QUERY, EPB = 3, 2, 2
NAN_CASES = [((), 4), ((2,), 1), ((1,), 2), ((3,), 0), ((0, 2), 1)]  # rank 1 holds 2 and 3


def _init(module, *shapes, seed=1):
    """Flax variables drawn with numpy over ``init``'s tree (nothing compiled)."""
    return draw_variables(module, *(np.zeros(s, np.float32) for s in shapes), seed=seed)


def _cases(ds, tmp):
    """The step cases (port state dicts from JAX weights) and the JAX models."""
    img = (1, 32, 32, 3)
    j = {}
    cases = {}
    common = dict(images=ds.images, labels=ds.labels, mean=ds.mean, std=ds.std, lr=LR, wd=WD)

    j["pretrain"] = jc.Classifier(encoder=JVisformer(**TINY),
                                  classifier=jc.LinearClassifier(6, name="classifier"))
    v = _init(j["pretrain"], img)
    idx = batch_indices(len(ds), 8, t_rng.np_rng(5, 1))[:2]
    cases["pretrain"] = dict(common, kind="pretrain", encoder=TINY, n_classes=6,
                             state=from_flax(v), idx=idx, key=(5, 1), jvars=v)
    drop = dict(TINY, drop_path_rate=0.2)
    jd = jc.Classifier(encoder=JVisformer(**drop),
                       classifier=jc.LinearClassifier(6, name="classifier"))
    cases["pretrain_draws"] = dict(cases["pretrain"], encoder=drop, augment=True,
                                   state=from_flax(_init(jd, img)), jvars=None)

    j["sun"] = JTokenLabel(encoder=JVisformer(**TINY), n_classes=6)
    sv, tv = _init(j["sun"], img, seed=1), _init(j["sun"], img, seed=2)
    idx = batch_indices(len(ds), 4, t_rng.np_rng(6, 1))[:2]
    cases["sun"] = dict(common, kind="sun", encoder=TINY, n_classes=6, state=from_flax(sv),
                        teacher=from_flax(tv), idx=idx, key=(6, 1), sun_kw=SUN_KW, jvars=sv,
                        jteacher=tv)
    jsd = JTokenLabel(encoder=JVisformer(**drop), n_classes=6)
    cases["sun_draws"] = dict(cases["sun"], encoder=drop, augment=True,
                              state=from_flax(_init(jsd, img, seed=1)),
                              teacher=from_flax(_init(jsd, img, seed=2)), jvars=None)

    j["meta_tune"] = JMetaBaseline(encoder=JVisformer(**TINY))
    mv = _init(j["meta_tune"], (1, WAY, 1, 32, 32, 3), (1, WAY * QUERY, 32, 32, 3))
    sampler = EpisodeSampler(ds.labels, 2, WAY, 1 + QUERY, EPB)
    idx = np.stack(list(sampler.epoch(t_rng.np_rng(11, 1)))).astype(np.int32)
    cases["meta_tune"] = dict(common, kind="meta_tune", encoder=TINY, state=from_flax(mv),
                              idx=idx, key=(11, 1), way=WAY, query=QUERY, epb=EPB, jvars=mv)

    j["sund"] = JDeepEMD(encoder=JVisformer(**TINY), solver_iters=20)
    ev = _init(j["sund"], img, seed=2)
    n = 2 * (1 + 2)
    idx = np.random.default_rng(8).integers(0, len(ds), (2, EPB, n)).astype(np.int32)
    cases["sund"] = dict(common, kind="sund", encoder=TINY, state=from_flax(ev), idx=idx,
                         key=(0, 1), way=2, query=2, epb=EPB, jvars=ev,
                         cfg={"lr": 0.02, "step_size": 1, "gamma": 0.5, "max_epoch": 2})

    marks = np.zeros((2, 4, 4, 3), np.uint8)
    marks[0] = 255  # image 0 marks a NaN episode
    base = np.tile(np.arange(2, dtype=np.float32)[None], (4, 1))
    for nan_eps, n_keep in NAN_CASES:
        rows = [[0 if e in nan_eps else 1] * 6 for e in range(4)]
        cases[f"nan{nan_eps}"] = dict(kind="nan", images=marks, base=base, lr=0.5, way=2,
                                      query=2, epb=4, key=(0, 1), n_keep=n_keep,
                                      idx=np.asarray(rows, np.int32)[None])

    j["tp"] = jc.Classifier(encoder=JVisformer(**TP_ENC),
                            classifier=jc.LinearClassifier(6, name="classifier"))
    tpv = _init(j["tp"], img, seed=0)
    tp = dict(common, kind="pretrain", encoder=TP_ENC, n_classes=6, state=from_flax(tpv),
              idx=batch_indices(len(ds), 16, t_rng.np_rng(7, 1))[:1], key=(7, 1),
              min_features=64, jvars=tpv)
    strip = lambda c: {k: v for k, v in c.items() if not k.startswith("j")}
    torch.save({k: strip(c) for k, c in cases.items()}, tmp / "steps.pt")
    torch.save({"tp": strip(tp)}, tmp / "tp.pt")
    return cases, tp, j


def _cli_runs(tmp):
    """The four trainer CLIs' configs under ``mesh: {data: 2}``."""
    save = str(tmp / "save")
    texts = {
        "pretrain": test_torch_pretrain.CLI_CONFIG % (2, "adamw", 0, "mesh: {data: 2}"),
        "sun": test_torch_sun.SUN_CLI % ("null", 1, "float32", "mesh: {data: 2}"),
        "meta_tune": test_torch_meta_tune.CLI_CONFIG % (1, "mesh: {data: 2}"),
        "meta_tune_emd": test_torch_sund_train.CLI_CONFIG % (
            "grid", 1, "mesh: {data: 2}\ndistributed: true"),
    }
    runs = []
    for name, text in texts.items():
        path = tmp / f"{name}.yaml"
        path.write_text(text)
        runs.append((name, ["--config", str(path), "--save-root", save, "--name", name,
                            "--device", "cpu"]))
    torch.save(runs, tmp / "clis.pt")
    return runs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the three rank groups, compute JAX's epochs and the port's
    one-process epochs while they run, then collect every rank's output."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    ds = synthetic(n_classes=6, n_per_class=8, image_size=32, seed=2)
    cases, tp, jmodels = _cases(ds, tmp)
    runs = _cli_runs(tmp)
    groups = {"steps": launch_ranks("steps", tmp, 2), "tp": launch_ranks("tp", tmp, 4),
              "train_clis": launch_ranks("train_clis", tmp, 2)}
    try:
        jax_out = {name: _jax_epoch(name, case, jmodels)
                   for name, case in cases.items() if case.get("jvars") is not None}
        jax_out["tp"] = _jax_epoch("pretrain", tp, {"pretrain": jmodels["tp"]})
        one = {name: run_step_case(case) for name, case in cases.items() if case["kind"] != "nan"}
        one["tp"] = run_step_case(tp)
    finally:
        stdout = {g: wait_ranks(p) for g, p in groups.items()}
    out = {g: rank_outputs(g, tmp, len(p)) for g, p in groups.items()}
    return dict(cases=cases, tp=tp, jax=jax_out, one=one, out=out, stdout=stdout, runs=runs,
                tmp=tmp)


def _jax_epoch(name, case, jmodels):
    images, idx = jnp.asarray(case["images"]), jnp.asarray(case["idx"])
    v = jax.tree_util.tree_map(jnp.asarray, case["jvars"])
    if name == "sund":
        tx = jt.build_sund_optimizer(JConfig(case["cfg"]), idx.shape[0])
        fn = jt.make_emd_episode_fn(jmodels["sund"], 2, 1, 2,
                                    jt.make_patch_fn("fcn", [2, 3], 9, 2.0, 32, True),
                                    case["mean"], case["std"], sfc=False, train=True)
        epoch = jt.make_emd_epoch_fn(fn, tx, jnp.tile(jnp.arange(2), 2), EPB)
        state, ms = epoch(JTrainState.create(v, tx), images, idx, jax.random.key(0))
    else:
        tx = j_make_optimizer(v["params"], "sgd", lr=LR, weight_decay=WD)
        state = JTrainState.create(v, tx)
        if name == "pretrain":
            epoch = jloop.make_pretrain_epoch(jmodels[name], tx, mean=case["mean"],
                                              std=case["std"])
            state, ms = epoch(state, images, jnp.asarray(case["labels"]), idx,
                              jax.random.key(0))
        elif name == "sun":
            epoch = jloop.make_sun_epoch(jmodels[name], jmodels[name], tx, mean=case["mean"],
                                         std=case["std"], **SUN_KW)
            state, ms = epoch(state, jax.tree_util.tree_map(jnp.asarray, case["jteacher"]),
                              images, jnp.asarray(case["labels"]), idx, jax.random.key(0))
        else:
            epoch = jloop.make_meta_tune_epoch(jmodels[name], tx, WAY, 1, QUERY, EPB,
                                               mean=case["mean"], std=case["std"])
            state, ms = epoch(state, images, idx, jax.random.key(0))
    want = {**from_flax({"params": numpy_tree(state.params)}),
            **from_flax({"batch_stats": numpy_tree(state.batch_stats)})}
    return {"variables": want, "ms": {k: np.asarray(m) for k, m in ms.items()}}


def _hold(got, want, start=None):
    """The trainer rules: loss and accuracy 1e-4, parameters 2e-5, BN
    statistics 1e-5; the stem's parameters 1e-3 of their max-abs."""
    for k in want["ms"]:
        np.testing.assert_allclose(np.asarray(got["ms"][k]), np.asarray(want["ms"][k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    gv, wv = got["variables"], want["variables"]
    assert sorted(gv) == sorted(wv)
    for k, v in wv.items():
        a, b = gv[k].numpy(), np.asarray(v)
        if k.endswith(("running_mean", "running_var")):
            tol = 1e-5
        elif ".stem." in f".{k}":
            tol = max(2e-5, 1e-3 * np.abs(b).max())
        else:
            tol = 2e-5
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=k)
    if start is not None:  # the epoch moved the weights
        moved = [k for k in wv if not torch.equal(gv[k], start[k])]
        assert len(moved) > len(wv) // 2


@pytest.mark.parametrize("name", ["pretrain", "sun", "meta_tune", "sund"])
def test_two_ranks_equal_jax_and_one_process(ranks, name):
    """Two data ranks, each with its block of the global batch (global BN
    statistics, averaged gradients; SUN-D: one episode a rank), against
    JAX's epoch on the global batch and the port's one-process epoch."""
    r0, r1 = (o[name] for o in ranks["out"]["steps"])
    for k, v in r0["variables"].items():  # every rank holds the same state
        assert torch.equal(v, r1["variables"][k]), k
    _hold(r0, ranks["jax"][name], start=ranks["cases"][name]["state"])
    _hold(r0, ranks["one"][name])


@pytest.mark.parametrize("name", ["pretrain_draws", "sun_draws"])
def test_two_ranks_draw_the_global_batch(ranks, name):
    """Drop-path masks, cropaug and the dual view drawn for the global batch
    and sliced: the two-rank epoch equals the one-process epoch."""
    r0 = ranks["out"]["steps"][0][name]
    _hold(r0, ranks["one"][name])


@pytest.mark.parametrize("nan_eps,n_keep", NAN_CASES)
def test_sund_nan_episodes_across_ranks_match_jax(ranks, nan_eps, n_keep):
    """``bs`` 4 over two ranks, NaN episodes planted on rank 0, rank 1 or
    both: the update is JAX's ``suffix_keep`` result, the sum over the
    episodes after the last NaN one over ``bs``, equal to JAX's vmapped
    ``make_emd_epoch_fn`` and to the closed form."""
    case = ranks["cases"][f"nan{nan_eps}"]
    labels, base = jnp.tile(jnp.arange(2), 2), jnp.asarray(case["base"])

    def j_episode_fn(variables, imgs, key):
        bad = jnp.where(imgs[0, 0, 0, 0].astype(jnp.float32) == 255.0, jnp.nan, 1.0)
        return variables["params"]["w"] * bad * base

    tx = optax.sgd(case["lr"])
    state = JTrainState.create({"params": {"w": jnp.float32(1.0)}}, tx)
    state, _ = jt.make_emd_epoch_fn(j_episode_fn, tx, labels, 4)(
        state, jnp.asarray(case["images"]), jnp.asarray(case["idx"]), jax.random.key(0))
    g1 = float(jax.grad(lambda p: optax.softmax_cross_entropy_with_integer_labels(
        p * base, labels).mean())(jnp.float32(1.0)))
    want = 1.0 - case["lr"] * (n_keep * g1 / 4)
    for out in ranks["out"]["steps"]:
        got = out[f"nan{nan_eps}"]
        w = got["variables"]["w"].item()
        assert w == pytest.approx(want, rel=1e-5, abs=1e-7)
        assert w == pytest.approx(float(state.params["w"]), rel=1e-6, abs=1e-7)
        assert got["variables"]["unused"].item() == 2.0
        assert bool(torch.isnan(got["ms"]["loss"][0])) == bool(nan_eps)


def test_data_and_model_axes_equal_the_unsharded_step_and_jax(ranks):
    """``{data: 2, model: 2}``: JAX's column-parallel rule at min_features
    64 slices the wide layers; every rank's step, gathered to the full
    layout, equals the step without the model axis and JAX's."""
    outs = ranks["out"]["tp"]
    sliced = outs[0]["sliced"]
    assert "encoder.stage2.0.attn.qkv" in sliced and "classifier.linear" not in sliced
    assert any(".conv2" in n for n in sliced)  # a grouped conv, its input channels split
    full = ranks["tp"]["state"]
    for name in sliced:  # each model rank holds its half of the output features
        w = name + ".weight"
        assert outs[0]["local"][w].shape[0] * 2 == full[w].shape[0]
        assert torch.equal(outs[0]["local"][w], full[w][:full[w].shape[0] // 2])
        assert torch.equal(outs[1]["local"][w], full[w][full[w].shape[0] // 2:])
    for out in outs:  # the gathered checkpoint: the unsharded layout
        got = out["tp"]["variables"]
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in full.items()}
    _hold(outs[0]["tp"], ranks["one"]["tp"], start=full)
    _hold(outs[0]["tp"], ranks["jax"]["tp"])
    for out in outs:  # a resume restores every slice and momentum buffer
        assert out["resumed"]
        assert out["saved_buf_shapes"] == {k: full[k].shape for k in out["saved_buf_shapes"]}
        assert len(out["saved_buf_shapes"]) == len([k for k in full if "running" not in k])
    for out in outs[1:]:
        for k, v in out["tp"]["variables"].items():
            assert torch.equal(v, outs[0]["tp"]["variables"][k]), k


@pytest.mark.parametrize("name", ["pretrain", "sun", "meta_tune", "meta_tune_emd"])
def test_trainer_clis_run_on_a_mesh_and_only_rank_zero_writes(ranks, name):
    """Each CLI under ``mesh: {data: 2}`` (SUN-D also ``distributed:``):
    rank 0 logs the mesh and the backend and writes the checkpoints; rank 1
    prints nothing."""
    out0, out1 = ranks["stdout"]["train_clis"]
    assert out1.strip() == ""
    part = out0.split(f"=== {name}\n")[1].split("\n=== ")[0]
    assert "mesh: {'data': 2} over 2 process(es)" in part and "backend gloo" in part, part
    assert ranks["out"]["train_clis"][0][name] == ranks["out"]["train_clis"][1][name] > 0
    run = ranks["tmp"] / "save" / name
    assert (run / "epoch-last" / "arrays.pt").is_file()
    assert (run / "resume" / "arrays.pt").is_file()
    log = (run / "log.txt").read_text()
    assert log.count("config: ") == 1  # one writer
