"""Port parity, SUN-M meta-tuning: the same weights and the same episode
indices through ``make_meta_tune_epoch`` on both sides (drop rates 0, so no
random draw is left), the per-epoch episode draws, ``check_standard_episodic``,
epoch-subset staging, and the CLI on ``--device cpu``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.core import rng as j_rng
from fewshot_vit_tpu.data.sampler import EpisodeSampler as JSampler
from fewshot_vit_tpu.heads import MetaBaseline as JMetaBaseline
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.train.loop import make_meta_tune_epoch as j_epoch_fn
from fewshot_vit_tpu.train.optim import make_optimizer as j_make_optimizer
from fewshot_vit_tpu.train.optim import multistep_schedule as j_multistep
from fewshot_vit_tpu.train.state import TrainState as JTrainState
from fewshot_vit_tpu_torch.checkpoint import from_flax, load_flax
from fewshot_vit_tpu_torch.core import rng as t_rng
from fewshot_vit_tpu_torch.data.datasets import synthetic
from fewshot_vit_tpu_torch.data.sampler import EpisodeSampler as TSampler
from fewshot_vit_tpu_torch.data.staging import epoch_subset, gpu_budget_gb, needs_staging
from fewshot_vit_tpu_torch.core.config import Config
from fewshot_vit_tpu_torch.heads.deepemd import DeepEMD as TDeepEMD
from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline as TMetaBaseline
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.train import meta_tune
from fewshot_vit_tpu_torch.train.loop import batch_indices, make_meta_tune_epoch, metrics_mean
from fewshot_vit_tpu_torch.train.optim import make_optimizer, multistep_schedule
from fewshot_vit_tpu_torch.train.runner import parse_args
from fewshot_vit_tpu_torch.train.state import TrainState

from .torch_port_helpers import numpy_tree, randomize_bn

torch.set_num_threads(1)
TINY = dict(img_size=32, init_channels=8, embed_dim=48, depth=(1, 1, 1), num_heads=6)
WAY, SHOT, QUERY, EPB, STEPS, EPOCHS, SEED = 3, 1, 2, 2, 3, 2, 11
LR, WD = 0.02, 5e-4  # 20 times the configs' rate, so six steps move the weights


@pytest.fixture(scope="module")
def setup():
    ds = synthetic(n_classes=6, n_per_class=8, image_size=32, seed=2)
    jhead = JMetaBaseline(encoder=JVisformer(**TINY))
    xs = jnp.zeros((1, WAY, SHOT, 32, 32, 3))
    xq = jnp.zeros((1, WAY * QUERY, 32, 32, 3))
    variables = randomize_bn(numpy_tree(jhead.init(jax.random.key(1), xs, xq)))
    sampler = TSampler(ds.labels, STEPS, WAY, SHOT + QUERY, EPB)
    idx = [np.stack(list(sampler.epoch(t_rng.np_rng(SEED, e)))).astype(np.int32)
           for e in range(1, EPOCHS + 1)]
    return ds, jhead, variables, idx


def _port_state(variables):
    head = load_flax(TMetaBaseline(TVisformer(**TINY, device="cpu")), variables)
    sched = multistep_schedule(LR, [1], 0.5)  # the milestone falls between the two epochs
    return TrainState(head, make_optimizer(head.parameters(), "sgd", lr=LR, weight_decay=WD,
                                           schedule=sched))


def _run_port(ds, variables, idx, freeze_bn, images=None, idx_override=None):
    state = _port_state(variables)
    epoch = make_meta_tune_epoch(WAY, SHOT, QUERY, EPB, freeze_bn=freeze_bn,
                                 mean=ds.mean, std=ds.std)
    out = []
    for e in range(EPOCHS):
        state.optimizer.set_epoch(e)
        imgs = torch.from_numpy(ds.images if images is None else images[e])
        ix = torch.from_numpy((idx if idx_override is None else idx_override)[e].astype(np.int64))
        out.append(epoch(state, imgs, ix, (SEED, e + 1)))
    return state, out


@pytest.mark.parametrize("freeze_bn", [False, True])
def test_trajectory_matches_jax(setup, freeze_bn):
    """2 epochs of 3 steps across a milestone: per-step loss and accuracy
    within 1e-4, final parameters within 2e-5, final BN statistics within
    1e-5."""
    ds, jhead, variables, idx = setup
    tx = j_make_optimizer(variables["params"], "sgd", lr=LR, weight_decay=WD,
                          schedule=j_multistep(LR, STEPS, [1], 0.5))
    jstate = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    j_epoch = j_epoch_fn(jhead, tx, WAY, SHOT, QUERY, EPB, freeze_bn=freeze_bn,
                         mean=ds.mean, std=ds.std)
    j_ms = []
    for e in range(EPOCHS):
        jstate, ms = j_epoch(jstate, jnp.asarray(ds.images), jnp.asarray(idx[e]),
                             jax.random.key(e))
        j_ms.append({k: np.asarray(v) for k, v in ms.items()})

    state, t_ms = _run_port(ds, variables, idx, freeze_bn)
    assert state.step == STEPS * EPOCHS and state.optimizer.lr == pytest.approx(LR / 2)
    for jm, tm in zip(j_ms, t_ms):
        assert tm["loss"].shape == (STEPS,)
        np.testing.assert_allclose(tm["loss"].numpy(), jm["loss"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(tm["acc"].numpy(), jm["acc"], rtol=0, atol=1e-4)
    got = state.variables
    want_p = from_flax({"params": numpy_tree(jstate.params)})
    want_s = from_flax({"batch_stats": numpy_tree(jstate.batch_stats)})
    assert sorted(got) == sorted({**want_p, **want_s})
    start = from_flax(variables)
    for k, v in want_p.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=2e-5, err_msg=k)
        # it moved, unless JAX's did not (a zero bias in front of a batch-statistics BN)
        moved = lambda t: not np.allclose(t.numpy(), start[k].numpy(), rtol=0, atol=1e-7)
        assert moved(got[k]) == moved(v), k
    for k, v in want_s.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
        assert torch.equal(got[k], start[k]) == freeze_bn, k  # frozen: bit-identical
    assert metrics_mean(t_ms[0])["loss"] == pytest.approx(float(np.mean(j_ms[0]["loss"])),
                                                          abs=1e-4)


def test_episode_index_matrices_identical_to_jax(setup):
    ds, _, _, idx = setup
    sampler = JSampler(ds.labels, STEPS, WAY, SHOT + QUERY, EPB)
    for e in range(1, EPOCHS + 1):
        want = np.stack(list(sampler.epoch(j_rng.np_rng(SEED, e)))).astype(np.int32)
        np.testing.assert_array_equal(idx[e - 1], want)
    assert not np.array_equal(idx[0], idx[1])
    from fewshot_vit_tpu.train.loop import batch_indices as j_batch_indices
    for drop_last in (True, False):
        np.testing.assert_array_equal(
            batch_indices(23, 5, t_rng.np_rng(3, 1), drop_last),
            j_batch_indices(23, 5, j_rng.np_rng(3, 1), drop_last))


def test_check_standard_episodic():
    enc = TVisformer(**TINY, device="cpu")
    meta_tune.check_standard_episodic(TMetaBaseline(enc), "meta-baseline")
    with pytest.raises(ValueError, match="standard episodic"):
        meta_tune.check_standard_episodic(TDeepEMD(enc), "deepemd")


def test_staging_gives_the_same_losses_as_the_resident_path(setup):
    ds, _, variables, idx = setup
    assert not needs_staging(ds.images) and needs_staging(ds.images, budget_gb=1e-6)
    assert gpu_budget_gb(Config({"hbm_budget_gb": 2})) == 2.0  # the JAX key, as an alias
    assert gpu_budget_gb(Config({"gpu_budget_gb": 3, "hbm_budget_gb": 2})) == 3.0
    cap = STEPS * EPB * WAY * (SHOT + QUERY)
    staged = [epoch_subset(ds.images, ix, cap) for ix in idx]
    for (subset, local), ix in zip(staged, idx):
        assert subset.shape == (cap, 32, 32, 3) and local.dtype == np.int32
        np.testing.assert_array_equal(subset[local], ds.images[ix])
    with pytest.raises(ValueError, match="unique images"):
        epoch_subset(ds.images, idx[0], 3)
    _, resident = _run_port(ds, variables, idx, False)
    _, through = _run_port(ds, variables, idx, False, images=[s for s, _ in staged],
                           idx_override=[i for _, i in staged])
    for a, b in zip(resident, through):
        assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["acc"], b["acc"])


CLI_CONFIG = """
train_dataset: synthetic
train_dataset_args: {n_classes: 6, n_per_class: 8, image_size: 32, seed: 2}
val_dataset: synthetic
val_dataset_args: {n_classes: 5, n_per_class: 6, image_size: 32, seed: 3}
tval_dataset: synthetic
tval_dataset_args: {n_classes: 5, n_per_class: 6, image_size: 32, seed: 4}
model: meta-baseline
model_args:
  encoder: visformer_micro_80
  encoder_args: {img_size: 32, init_channels: 8, embed_dim: 48, depth: [1, 1, 1],
                 drop_path_rate: 0.5}
n_way: 3
n_shot: 1
n_query: 2
n_train_way: 4
n_train_query: 1
ep_per_batch: 2
train_batches: 2
max_epoch: %d
save_epoch: 2
optimizer: sgd
optimizer_args: {lr: 1.e-3, weight_decay: 5.e-4, milestones: [1], gamma: 0.5}
val_episodes: 4
tval_episodes: 2
%s
"""


def test_cli_on_cpu_writes_checkpoints_and_resumes(tmp_path, capsys):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(CLI_CONFIG % (2, ""))
    argv = ["--config", str(cfg), "--save-root", str(tmp_path / "save"), "--name", "run",
            "--device", "cpu"]
    state = meta_tune.main(*parse_args("test", argv))
    out = capsys.readouterr().out
    assert "epoch 1 lr=0.001" in out and "epoch 2 lr=0.0005" in out and "tval acc=" in out
    assert state.step == 4
    run = tmp_path / "save" / "run"
    for name in ("epoch-last", "epoch-2", "max-va", "resume"):
        assert (run / name / "arrays.pt").is_file() and (run / name / "meta.json").is_file(), name
    assert not (run / "epoch-1").exists()
    assert len((run / "metrics.jsonl").read_text().splitlines()) == 2

    # a second invocation with resume: nothing left at 2 epochs, epoch 3 at 3
    cfg.write_text(CLI_CONFIG % (2, "resume: true"))
    meta_tune.main(*parse_args("test", argv))
    out = capsys.readouterr().out
    assert "resumed full train state from epoch 2" in out and "nothing left to do" in out
    cfg.write_text(CLI_CONFIG % (3, "resume: true"))
    resumed = meta_tune.main(*parse_args("test", argv))
    out = capsys.readouterr().out
    assert "epoch 3 lr=0.0005" in out and "epoch 2 " not in out
    assert resumed.step == 6
    # the resumed optimizer carried its momentum buffers
    assert len(resumed.optimizer.state_dict()["state"]) == len(list(resumed.module.parameters()))


def test_cli_writes_the_dataset_grids(tmp_path):
    """``visualize_datasets: true``: one grid PNG per split, JAX's names."""
    cfg = tmp_path / "c.yaml"
    cfg.write_text(CLI_CONFIG % (1, "visualize_datasets: true"))
    meta_tune.main(*parse_args("test", ["--config", str(cfg), "--save-root", str(tmp_path / "s"),
                                        "--name", "run", "--device", "cpu"]))
    pngs = sorted(p.name for p in (tmp_path / "s" / "run").glob("*.png"))
    assert pngs == ["visualize_train_dataset.png", "visualize_tval_dataset.png",
                    "visualize_val_dataset.png"]


def test_cli_refuses_multi_device_keys_and_a_missing_card(tmp_path, monkeypatch):
    cfg = tmp_path / "c.yaml"
    argv = ["--config", str(cfg), "--save-root", str(tmp_path / "s"), "--device", "cpu"]
    for key in ("mesh: {data: 4}", "distributed: true"):
        cfg.write_text(CLI_CONFIG % (1, key))
        with pytest.raises(NotImplementedError, match="auxiliaries slice"):
            meta_tune.main(*parse_args("test", argv))
    assert not (tmp_path / "s").exists()  # refused before a run directory is made
    cfg.write_text(CLI_CONFIG % (1, ""))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_, args = parse_args("test", ["--config", str(cfg), "--save-root", str(tmp_path / "s")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        meta_tune.main(cfg_, args)
