"""Port parity, ``solver: exact``: the C++ transportation simplex built from
the port's own copy of the source into ``build/native/``.

  * ``native.emd.emd_exact`` against the JAX package's on the same float64
    problems: flows and objectives bit-identical (same source, same flags,
    same inputs);
  * ``emd_logits(solver_impl="exact")`` against JAX's on the 1-shot grid
    (13 nodes): logits within 1e-5, per-episode accuracies bit-identical;
    the gradient reaches the inputs only through ``sim``, as JAX's;
  * the ``run_emd`` CLI with ``solver: exact`` prints the JAX CLI's line;
  * one ``meta_tune_emd`` step with ``solver: exact`` against JAX: loss
    within 1e-4, parameters within 2e-5;
  * the port builds and loads nothing under ``fewshot_vit_tpu/native/``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.core.config import Config as JConfig
from fewshot_vit_tpu.core.registry import models as j_models
from fewshot_vit_tpu.eval import run_emd as j_run_emd
from fewshot_vit_tpu.heads import deepemd as jd
from fewshot_vit_tpu.heads.deepemd import DeepEMD as JDeepEMD
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.native import emd as j_native
from fewshot_vit_tpu.train import meta_tune_emd as jt
from fewshot_vit_tpu.train.state import TrainState as JTrainState
from fewshot_vit_tpu_torch.checkpoint import from_flax, load_flax
from fewshot_vit_tpu_torch.core.config import Config
from fewshot_vit_tpu_torch.eval import run_emd
from fewshot_vit_tpu_torch.heads import deepemd as td
from fewshot_vit_tpu_torch.heads.deepemd import DeepEMD as TDeepEMD
from fewshot_vit_tpu_torch.kernels import sinkhorn as tks
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.native import emd as t_native
from fewshot_vit_tpu_torch.ops import emd as temd
from fewshot_vit_tpu_torch.ops.metric import per_episode_acc
from fewshot_vit_tpu_torch.train import meta_tune_emd as tt
from fewshot_vit_tpu_torch.train.state import TrainState

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _problems(seed, b, n):
    rng = np.random.default_rng(seed)
    cost = rng.random((b, n, n))
    w1, w2 = rng.random((b, n)) + 1e-3, rng.random((b, n)) + 1e-3
    return cost, w1 / w1.sum(-1, keepdims=True), w2 / w2.sum(-1, keepdims=True)


@pytest.mark.parametrize("n", [5, 9, 13, 25])
def test_emd_exact_is_bit_identical_to_jax(n):
    cost, w1, w2 = _problems(n, 64, n)
    want_f, want_c = j_native.emd_exact(cost, w1, w2)
    got_f, got_c = t_native.emd_exact(cost, w1, w2)
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_array_equal(got_c, want_c)
    # an optimal flow: both marginals met, objective no more than Sinkhorn's
    np.testing.assert_allclose(got_f.sum(-1), w1, atol=1e-12)
    np.testing.assert_allclose(got_f.sum(-2), w2, atol=1e-12)
    sk = temd.sinkhorn(torch.from_numpy(cost), torch.from_numpy(w1), torch.from_numpy(w2),
                       reg=0.05, iters=200).numpy()
    assert (got_c <= (sk * cost).sum((-2, -1)) + 1e-9).all()


def test_solver_source_is_the_jax_file():
    with open(os.path.join(REPO, "fewshot_vit_tpu", "native", "emd_solver.cpp")) as f:
        want = f.read()
    assert t_native.SRC.read_text() == want


def _nodes(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_emd_logits_exact_matches_jax_on_the_grid():
    """1-shot grid, 13 nodes of 32 channels, 4 episodes of 5-way 15-query:
    logits within 1e-5 and per-episode accuracies bit-identical."""
    proto, query = _nodes(1, 4, 5, 13, 32), _nodes(2, 4, 75, 13, 32)
    query[:, :, :, :8] += np.repeat(proto[:, :, :, :8], 15, axis=1)  # queries near their class
    want = jd.emd_logits(jnp.asarray(proto), jnp.asarray(query), solver_impl="exact")
    got = td.emd_logits(torch.from_numpy(proto), torch.from_numpy(query), solver_impl="exact")
    assert got.shape == (4, 75, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    label = np.tile(np.arange(5), 15)[None].repeat(4, 0)
    j_acc = np.mean(np.asarray(jnp.argmax(want, -1)) == label, axis=-1).astype(np.float32)
    t_acc = per_episode_acc(got, torch.from_numpy(label)).numpy()
    np.testing.assert_array_equal(t_acc, j_acc)
    assert 0.0 < t_acc.mean() < 1.0


def test_exact_gradient_only_through_sim():
    """Flows are constants: the port's gradient equals JAX's (``pure_callback``
    under ``stop_gradient``) and the one of sum(sim * flow) with the flow
    held fixed."""
    proto, query = _nodes(3, 2, 3, 9, 16), _nodes(4, 2, 4, 9, 16)
    want = jax.grad(lambda p: jd.emd_logits(p, jnp.asarray(query), solver_impl="exact").sum())(
        jnp.asarray(proto))
    p = torch.from_numpy(proto).requires_grad_(True)
    (got,) = torch.autograd.grad(td.emd_logits(p, torch.from_numpy(query),
                                               solver_impl="exact").sum(), p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    q = torch.from_numpy(query)
    sim = td.similarity_map(td.center_normalize(p), td.center_normalize(q))
    with torch.no_grad():
        w1 = temd.normalize_weights(td.weight_vector(q, p))
        w2 = temd.normalize_weights(td.weight_vector(p, q).transpose(-2, -3))
        flow = td.exact_flows(1.0 - sim, w1, w2)
    (fixed,) = torch.autograd.grad(temd.emd_distance(sim, flow, 12.5).sum(), p)
    torch.testing.assert_close(got, fixed, rtol=0, atol=0)
    assert flow.dtype == torch.float32 and flow.device == p.device


def test_exact_flows_count_host_seconds():
    before = td.exact_flows.host_seconds
    cost, w1, w2 = (torch.from_numpy(a).float() for a in _problems(5, 8, 13))
    td.exact_flows(cost, w1, w2)
    assert td.exact_flows.host_seconds > before


# --- the CLI -------------------------------------------------------------------------

NAME = "visformer_micro_80"
DATA = dict(n_classes=6, n_per_class=20, image_size=80, seed=2)
ENC_ARGS = "{init_channels: 16, embed_dim: 96, depth: [1, 1, 1]}"


@pytest.fixture
def narrow_jax_visformer(monkeypatch):
    """The JAX registry's ``visformer_micro_80`` fixes its widths; the JAX
    CLI builds the narrow test encoder through the config's ``encoder_args``."""
    monkeypatch.setitem(j_models._ctors, NAME, lambda **kw: JVisformer(**{**SMALL_VISFORMER,
                                                                           **kw}))


def test_run_emd_cli_exact_prints_the_jax_line(tmp_path, capsys, monkeypatch,
                                               narrow_jax_visformer):
    jenc = JVisformer(**SMALL_VISFORMER)
    variables = randomize_bn(numpy_tree(jenc.init(jax.random.key(1),
                                                  jnp.zeros((1, 80, 80, 3), jnp.float32))))
    enc_sd = from_flax(variables, encoder=NAME)
    pth = tmp_path / "enc.pth"
    torch.save({"model_sd": {"encoder." + k: v for k, v in enc_sd.items()}}, pth)
    cfg = tmp_path / "emd.yaml"
    cfg.write_text("val_dataset: synthetic-local\n" + f"val_dataset_args: {DATA}\n".replace("'", "")
                   + "deepemd: grid\nway: 3\nquery: 2\nsolver: exact\n"
                   f"model_args: {{encoder: {NAME}, encoder_args: {ENC_ARGS}}}\n"
                   f"load_encoder: {pth}\n")
    argv = ["--config", str(cfg), "--episodes", "4", "--ep-per-batch", "2"]
    monkeypatch.setattr(sys, "argv", ["run_emd"] + argv)
    j_run_emd.main()
    want = [ln for ln in capsys.readouterr().out.splitlines() if "acc=" in ln]
    launches = tks.sinkhorn_pallas.launches
    accs = run_emd.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    got = [ln for ln in out.splitlines() if "acc=" in ln]
    assert len(want) == 1 and got == want
    assert accs.shape == (4,) and "WARNING" not in out  # no card: no host-solver warning
    assert tks.sinkhorn_pallas.launches == launches


def test_run_emd_warns_of_the_host_solver_on_the_card(tmp_path, monkeypatch, capsys):
    """On ``--device cuda`` the CLI says that the simplex runs on the host
    (the device check runs first, so without a card this stops there)."""
    cfg = tmp_path / "e.yaml"
    cfg.write_text("val_dataset: synthetic-local\nval_dataset_args: {n_classes: 3}\n"
                   "solver: exact\n")
    monkeypatch.setattr(run_emd, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(run_emd.datasets, "make", lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("stop")))
    with pytest.raises(RuntimeError, match="stop"):
        run_emd.main(["--config", str(cfg)])
    assert run_emd.EXACT_ON_CARD in capsys.readouterr().out


# --- one training step -----------------------------------------------------------------

TINY = dict(img_size=32, init_channels=8, embed_dim=48, depth=(1, 1, 1), num_heads=6)
WAY, SHOT, QUERY = 2, 1, 2
MEAN, STD = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)


def test_meta_tune_emd_step_exact_matches_jax():
    """fcn (no random draw), ``bs`` 2, one SGD step through
    ``build_sund_optimizer`` on both sides: loss within 1e-4, parameters
    within 2e-5 and moved, BN statistics untouched."""
    jhead = JDeepEMD(encoder=JVisformer(**TINY), solver="exact")
    variables = randomize_bn(numpy_tree(
        jhead.init(jax.random.key(2), jnp.zeros((1, 32, 32, 3), jnp.float32))))
    images = (np.random.default_rng(3).random((40, 32, 32, 3)) * 255).astype(np.uint8)
    cfg = {"lr": 0.02, "step_size": 1, "gamma": 0.5, "max_epoch": 1}
    epb, n = 2, WAY * (SHOT + QUERY)
    idx = np.random.default_rng(8).integers(0, 40, (1, epb, n)).astype(np.int32)

    tx = jt.build_sund_optimizer(JConfig(cfg), 1)
    j_fn = jt.make_emd_episode_fn(jhead, WAY, SHOT, QUERY,
                                  jt.make_patch_fn("fcn", [2, 3], 9, 2.0, 32, True),
                                  MEAN, STD, sfc=False, train=True)
    j_epoch = jt.make_emd_epoch_fn(j_fn, tx, jnp.tile(jnp.arange(WAY), QUERY), epb)
    jstate = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jstate, j_ms = j_epoch(jstate, jnp.asarray(images), jnp.asarray(idx), jax.random.key(0))

    head = load_flax(TDeepEMD(TVisformer(**TINY, device="cpu"), solver="exact"), variables)
    fn = tt.make_emd_episode_fn(head, WAY, SHOT, QUERY, tt.make_patch_fn("fcn", [2, 3], 2.0, 32,
                                                                       train=True),
                                MEAN, STD, sfc=False, train=True)
    state = TrainState(head, tt.build_sund_optimizer(Config(cfg), head.parameters()))
    state.optimizer.set_epoch(0)
    epoch = tt.make_emd_epoch_fn(fn, torch.arange(WAY).repeat(QUERY), epb)
    ms = epoch(state, torch.from_numpy(images), torch.from_numpy(idx.astype(np.int64)), (0, 1))
    np.testing.assert_allclose(ms["loss"].numpy(), np.asarray(j_ms["loss"]), rtol=0, atol=1e-4)
    assert np.isfinite(ms["loss"].numpy()).all() and state.step == 1
    got, start = state.variables, from_flax(variables)
    for k, v in from_flax({"params": numpy_tree(jstate.params)}).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=2e-5, err_msg=k)
    assert any(not torch.equal(got[k], start[k]) for k in start if "running" not in k)
    for k in from_flax({"batch_stats": variables["batch_stats"]}):
        assert torch.equal(got[k], start[k]), k


# --- where the library goes ---------------------------------------------------------


def test_library_builds_only_under_build_native(tmp_path, monkeypatch):
    """A fresh build lands in the port's build directory (here redirected to
    ``tmp_path``), under a temporary name renamed into place; the JAX
    package's ``native/`` directory is neither written nor read."""
    assert t_native.LIB == __import__("pathlib").Path(REPO, "build", "native", "libemd.so")
    jdir = os.path.join(REPO, "fewshot_vit_tpu", "native")
    before = {f: os.stat(os.path.join(jdir, f)).st_mtime_ns for f in os.listdir(jdir)}
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(t_native, "LIB", tmp_path / "native" / "libemd.so")
    monkeypatch.setattr(t_native, "_lib", None)
    flows, _ = t_native.emd_exact(*_problems(0, 4, 5))
    assert flows.shape == (4, 5, 5)
    assert os.listdir(tmp_path / "native") == ["libemd.so"]
    assert t_native._lib._name == str(tmp_path / "native" / "libemd.so")
    after = {f: os.stat(os.path.join(jdir, f)).st_mtime_ns for f in os.listdir(jdir)}
    assert after == before
