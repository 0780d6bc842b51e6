"""Port parity, phase 1: 3-step trajectories of the pretrain step against the
JAX package's (plain, EMA, SAM and adaptive SAM), the validation CE epoch
with its ``n_valid`` mask, the few-shot validation hooks, ``EpochStager``,
``resume_train_state`` across EMA toggles, and the CLI on ``--device cpu``.

Trajectories: the same weights (non-trivial BN statistics), the same batch
indices, drop rates 0 and plain normalization, so no random draw is left;
per-step loss within 1e-4, parameters within 2e-5, BN statistics within
1e-5. SGD with momentum: its update is linear in the gradient, so XLA:CPU's
fp32 rounding in the stem's batch-statistics BN backward (up to 5.6e-3 of
those tensors' max-abs, ``ROADMAP.md`` section 3) stays below the parameter
tolerance, where Adam's normalized first steps would amplify it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.core import rng as j_rng
from fewshot_vit_tpu.data.staging import EpochStager as JStager
from fewshot_vit_tpu.heads import classifier as jc
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.train import loop as jloop
from fewshot_vit_tpu.train import runner as jrunner
from fewshot_vit_tpu.train.optim import make_optimizer as j_make_optimizer
from fewshot_vit_tpu.train.state import TrainState as JTrainState
from fewshot_vit_tpu_torch.checkpoint import from_flax, load_flax
from fewshot_vit_tpu_torch.checkpoint.io import save_variables
from fewshot_vit_tpu_torch.core import rng as t_rng
from fewshot_vit_tpu_torch.data.datasets import synthetic
from fewshot_vit_tpu_torch.data.staging import EpochStager
from fewshot_vit_tpu_torch.heads.classifier import make_classifier
from fewshot_vit_tpu_torch.train import loop as tloop
from fewshot_vit_tpu_torch.train import pretrain, runner
from fewshot_vit_tpu_torch.train.optim import make_optimizer
from fewshot_vit_tpu_torch.train.state import TrainState, resume_train_state

from .torch_port_helpers import numpy_tree, randomize_bn

torch.set_num_threads(1)
TINY = dict(img_size=32, init_channels=8, embed_dim=48, depth=(1, 1, 1), num_heads=6)
N_CLASSES, BATCH, STEPS, LR, WD = 6, 8, 3, 0.05, 5e-4


@pytest.fixture(scope="module")
def setup():
    ds = synthetic(n_classes=N_CLASSES, n_per_class=4, image_size=32, seed=2)
    jmodel = jc.Classifier(encoder=JVisformer(**TINY),
                           classifier=jc.LinearClassifier(N_CLASSES, name="classifier"))
    variables = randomize_bn(numpy_tree(jmodel.init(jax.random.key(1),
                                                    jnp.zeros((1, 32, 32, 3)))))
    idx = tloop.batch_indices(len(ds), BATCH, t_rng.np_rng(5, 1))[:STEPS]
    return ds, jmodel, variables, idx


def _port_model(variables):
    model = make_classifier("visformer_micro_80", encoder_args=TINY,
                            classifier_args={"n_classes": N_CLASSES}, device="cpu")
    return load_flax(model, variables)


def _compare_state(got, jparams, jstats, start, ema=None, jema=None):
    want_p = from_flax({"params": numpy_tree(jparams)})
    want_s = from_flax({"batch_stats": numpy_tree(jstats)})
    assert sorted(got) == sorted({**want_p, **want_s})
    moved = 0
    for k, v in want_p.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=2e-5, err_msg=k)
        moved += not torch.equal(got[k], start[k])
    assert moved > len(want_p) // 2  # the steps moved the weights
    for k, v in want_s.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
        assert not torch.equal(got[k], start[k]), k
    if jema is not None:
        for k, v in from_flax({"params": numpy_tree(jema)}).items():
            np.testing.assert_allclose(ema[k].numpy(), v.numpy(), rtol=0, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("variant", ["plain", "ema", "sam", "sam-adaptive"])
def test_pretrain_trajectory_matches_jax(setup, variant):
    ds, jmodel, variables, idx = setup
    kw = {"ema": {"ema_decay": 0.9},
          "sam": {"sam_rho": 0.05},
          "sam-adaptive": {"sam_rho": 0.5, "sam_adaptive": True}}.get(variant, {})
    tx = j_make_optimizer(variables["params"], "sgd", lr=LR, weight_decay=WD)
    jstate = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx,
                                ema=variant == "ema")
    j_epoch = jloop.make_pretrain_epoch(jmodel, tx, mean=ds.mean, std=ds.std, **kw)
    jstate, j_ms = j_epoch(jstate, jnp.asarray(ds.images), jnp.asarray(ds.labels),
                           jnp.asarray(idx), jax.random.key(0))

    model = _port_model(variables)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, make_optimizer(model.parameters(), "sgd", lr=LR, weight_decay=WD),
                       ema=variant == "ema")
    epoch = tloop.make_pretrain_epoch(None, ds.mean, ds.std, **kw)
    ms = epoch(state, torch.from_numpy(ds.images), torch.from_numpy(ds.labels.astype(np.int64)),
               torch.from_numpy(idx.astype(np.int64)), (5, 1))
    assert state.step == STEPS and ms["loss"].shape == (STEPS,)
    np.testing.assert_allclose(ms["loss"].numpy(), np.asarray(j_ms["loss"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ms["acc"].numpy(), np.asarray(j_ms["acc"]), rtol=0, atol=1e-4)
    _compare_state(state.variables, jstate.params, jstate.batch_stats, start,
                   state.ema_params, jstate.ema_params if variant == "ema" else None)


def test_sam_and_ema_refuse_each_other_and_remat():
    with pytest.raises(ValueError, match="ema_decay is not supported"):
        tloop.make_pretrain_epoch(sam_rho=0.05, ema_decay=0.9)
    with pytest.raises(ValueError, match="remat is not supported"):
        tloop.make_pretrain_epoch(sam_rho=0.05, remat=True)


def test_remat_gives_the_same_step(setup):
    """A checkpointed forward recomputes in the backward without updating
    the BN statistics twice: the same losses and weights as without it."""
    ds, _, variables, idx = setup
    out = []
    for remat in (False, True):
        model = _port_model(variables)
        state = TrainState(model, make_optimizer(model.parameters(), "sgd", lr=LR))
        ms = tloop.make_pretrain_epoch(None, ds.mean, ds.std, remat=remat)(
            state, torch.from_numpy(ds.images), torch.from_numpy(ds.labels.astype(np.int64)),
            torch.from_numpy(idx.astype(np.int64)), (5, 1))
        out.append((ms["loss"], state.variables))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=1e-6)
    for k in out[0][1]:
        torch.testing.assert_close(out[0][1][k], out[1][1][k], rtol=0, atol=1e-6, msg=k)


def test_eval_ce_epoch_masks_the_cycled_tail(setup):
    """11 images in batches of 4: the last batch cycles 1 image, which must
    not count twice; per-step sums as JAX's, means exact."""
    ds, jmodel, variables, _ = setup
    n = 11
    images, labels = ds.images[:n], ds.labels[:n]
    vidx = tloop.batch_indices(n, 4, t_rng.np_rng(0, 0), drop_last=False)
    assert vidx.shape == (3, 4)
    j_ms = jloop.make_eval_ce_epoch(jmodel, ds.mean, ds.std, n_valid=n)(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(images),
        jnp.asarray(labels), jnp.asarray(vidx))
    model = _port_model(variables)
    ms = tloop.make_eval_ce_epoch(ds.mean, ds.std, n_valid=n)(
        model, torch.from_numpy(images), torch.from_numpy(labels.astype(np.int64)),
        torch.from_numpy(vidx.astype(np.int64)))
    np.testing.assert_array_equal(ms["n"].numpy(), [4, 4, 3])
    np.testing.assert_array_equal(ms["correct"].numpy(), np.asarray(j_ms["correct"]))
    np.testing.assert_allclose(ms["loss_sum"].numpy(), np.asarray(j_ms["loss_sum"]),
                               rtol=1e-5, atol=1e-4)
    got, want = tloop.eval_metrics(ms), jloop.eval_metrics(j_ms)
    assert got["acc"] == want["acc"] and got["loss"] == pytest.approx(want["loss"], abs=1e-5)
    assert not model.training


def test_fs_eval_and_emd_fs_eval_identical_to_jax(setup):
    """The shared-encoder MetaBaseline view (1 and 5 shots) and the DeepEMD
    fcn view: per-run accuracies identical to the JAX hooks'."""
    _, jmodel, variables, _ = setup
    fs = synthetic(n_classes=5, n_per_class=20, image_size=32, seed=4)
    enc_vars = {col: tree["encoder"] for col, tree in variables.items()}
    jenc = JVisformer(**TINY)
    want = jrunner.fs_eval(jenc, jax.tree_util.tree_map(jnp.asarray, enc_vars), fs,
                           n_episodes=4, ep_per_batch=2)
    want.update(jrunner.emd_fs_eval(jenc, jax.tree_util.tree_map(jnp.asarray, enc_vars), fs,
                                    n_episodes=3))
    model = _port_model(variables)
    got = runner.fs_eval(model.encoder, fs, n_episodes=4, ep_per_batch=2)
    got.update(runner.emd_fs_eval(model.encoder, fs, n_episodes=3))
    assert sorted(got) == sorted(want) == ["emd_acc", "emd_ci", "fsa-1", "fsa-5"]
    for k in ("fsa-1", "fsa-5", "emd_acc"):
        assert np.float32(got[k]) == np.float32(want[k]), k
    assert got["emd_ci"] == pytest.approx(want["emd_ci"], rel=1e-5)


def test_epoch_stager_chunks_identical_to_jax():
    """A budget of three batches: 13 steps of 8 go in 5 chunks of 3 steps,
    the permutation cycled to fill the last; the same images, labels and
    chunk-local indices as the JAX stager's from the same generator."""
    ds = synthetic(n_classes=7, n_per_class=15, image_size=8, seed=1)
    budget = 3 * 8 * ds.images[0].nbytes / 2 ** 30
    js = JStager(ds.images, ds.labels, 8, budget_gb=budget)
    ts = EpochStager(ds.images, ds.labels, 8, budget_gb=budget, device="cpu")
    assert (ts.n_chunks, ts.chunk_steps, ts.chunk_imgs) == (js.n_chunks, js.chunk_steps,
                                                             js.chunk_imgs) == (5, 3, 24)
    n = 0  # compared chunk by chunk: the JAX stager frees a chunk once it moves on
    for (ji, jl, jx), (ti, tl, tx) in zip(js.epoch(j_rng.np_rng(3, 2)),
                                          ts.epoch(t_rng.np_rng(3, 2))):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        n += 1
    assert n == 5
    with pytest.raises(ValueError, match="smaller than batch size"):
        EpochStager(ds.images[:4], ds.labels[:4], 8, device="cpu")


@pytest.mark.parametrize("saved_ema,want_ema", [(False, False), (True, True),
                                                (False, True), (True, False)])
def test_resume_train_state_tolerates_an_ema_toggle(tmp_path, saved_ema, want_ema):
    enc = dict(TINY, depth=(1, 0, 0))

    def state(ema):
        model = make_classifier("visformer_micro_80", encoder_args=enc,
                                classifier_args={"n_classes": 3}, device="cpu")
        return TrainState(model, make_optimizer(model.parameters(), "adamw", lr=1e-3), ema=ema)

    saved = state(saved_ema)
    with torch.no_grad():
        for p in saved.module.parameters():
            p.add_(1.0)
        if saved_ema:
            for v in saved.ema_params.values():
                v.fill_(0.25)
    saved.step = 7
    save_variables(str(tmp_path / "resume"), saved.state_dict(), {"epoch": 3, "ema": saved_ema})
    st, meta, note = resume_train_state(str(tmp_path / "resume"), state(want_ema))
    assert meta["epoch"] == 3 and st.step == 7
    for k, v in saved.module.state_dict().items():
        assert torch.equal(st.module.state_dict()[k], v), k
    if not want_ema:
        assert st.ema_params is None
        assert (note is None) == (not saved_ema) and (saved_ema is False or "dropping" in note)
    elif saved_ema:
        assert note is None and all((v == 0.25).all() for v in st.ema_params.values())
    else:  # re-seeded from the loaded parameters
        assert "re-seeded" in note
        for n, p in st.module.named_parameters():
            assert torch.equal(st.ema_params[n], p.detach())


CLI_CONFIG = """
train_dataset: synthetic
train_dataset_args: {n_classes: 6, n_per_class: 8, image_size: 36, seed: 2}
val_dataset: synthetic
val_dataset_args: {n_classes: 6, n_per_class: 3, image_size: 32, seed: 3}
fs_dataset: synthetic
fs_dataset_args: {n_classes: 5, n_per_class: 20, image_size: 32, seed: 4}
model: classifier
model_args:
  encoder: visformer_micro_80
  encoder_args: {init_channels: 8, embed_dim: 48, depth: [1, 1, 1], drop_path_rate: 0.1,
                 use_pallas_attn: true}
batch_size: 16
max_epoch: %d
save_epoch: 2
optimizer: %s
optimizer_args: {lr: 1.e-3, weight_decay: 0.05, schedule: cosine, warmup_epochs: 1,
                 base: adamw, sam_rho: 0.05}
eval_fs_epoch: 2
eval_fs_episodes: 4
eval_emd: true
eval_emd_episodes: 2
augment: cropaug
image_size: 32
ema_decay: %s
%s
"""


def test_cli_on_cpu_trains_evaluates_checkpoints_and_resumes(tmp_path, capsys):
    """Two epochs of cropaug + EMA, then a resumed third with the EMA turned
    off, then SAM from scratch with the plain extra epoch (on a split already
    at the model's size)."""
    cfg = tmp_path / "c.yaml"
    cfg.write_text(CLI_CONFIG % (2, "adamw", 0.99, ""))
    argv = ["--config", str(cfg), "--save-root", str(tmp_path / "save"), "--name", "pre",
            "--device", "cpu"]
    state = pretrain.main(*runner.parse_args("test", argv))
    out = capsys.readouterr().out
    lines = {ln.split(" train")[0]: ln for ln in out.splitlines() if ln.startswith("epoch ")}
    assert "| val loss=" in lines["epoch 1"] and "ema val acc=" in lines["epoch 1"]
    assert "fsa-1=" not in lines["epoch 1"]  # few-shot validation every 2nd epoch
    assert "fsa-5=" in lines["epoch 2"] and "emd_acc=" in lines["epoch 2"]
    assert state.step == 2 * (48 // 16) and state.ema_params is not None
    run = tmp_path / "save" / "pre"
    for name in ("epoch-last", "epoch-2", "max-va", "resume", "ema/epoch-last", "ema/max-va"):
        assert (run / name / "arrays.pt").is_file(), name

    cfg.write_text(CLI_CONFIG % (3, "adamw", 0, "resume: true"))
    resumed = pretrain.main(*runner.parse_args("test", argv))
    out = capsys.readouterr().out
    assert "resumed full train state from epoch 2" in out and "dropping" in out
    assert "epoch 3 train" in out and "epoch 2 " not in out and resumed.step == 9

    cfg.write_text((CLI_CONFIG % (1, "sam", 0, "epoch_ex: true")).replace(
        "image_size: 36, seed: 2", "image_size: 32, seed: 2"))
    sam = pretrain.main(*runner.parse_args("test", argv[:-3] + ["sam", "--device", "cpu"]))
    out = capsys.readouterr().out
    assert "SAM pretraining" in out and "epoch-ex train loss=" in out and sam.step == 6
    assert (tmp_path / "save" / "sam" / "epoch-ex" / "arrays.pt").is_file()


def test_cli_writes_the_dataset_and_augmentation_grids(tmp_path):
    """``visualize_datasets: true``: a grid per split and the cropaug view."""
    cfg = tmp_path / "c.yaml"
    cfg.write_text(CLI_CONFIG % (1, "adamw", 0, "visualize_datasets: true"))
    pretrain.main(*runner.parse_args("t", ["--config", str(cfg), "--device", "cpu", "--name",
                                           "run", "--save-root", str(tmp_path / "s")]))
    pngs = sorted(p.name for p in (tmp_path / "s" / "run").glob("*.png"))
    assert pngs == ["visualize_fs_dataset.png", "visualize_train_aug.png",
                    "visualize_train_dataset.png", "visualize_val_dataset.png"]


def test_cli_defaults_to_the_card_and_refuses_auxiliaries(tmp_path, monkeypatch):
    cfg = tmp_path / "c.yaml"
    for extra in ("mesh: {data: 4}", "distributed: true\nmesh: {data: 4}"):
        cfg.write_text(CLI_CONFIG % (1, "adamw", 0, extra))
        with pytest.raises(ValueError, match=r"mesh \{'data': 4\} needs 4 devices, have 1"):
            pretrain.main(*runner.parse_args("t", ["--config", str(cfg), "--device", "cpu",
                                                   "--save-root", str(tmp_path / "s")]))
    cfg.write_text(CLI_CONFIG % (1, "adamw", 0, ""))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c, args = runner.parse_args("t", ["--config", str(cfg), "--save-root", str(tmp_path / "s")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain.main(c, args)
    assert not (tmp_path / "s").exists()
