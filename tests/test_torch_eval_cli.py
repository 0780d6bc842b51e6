"""The eval CLIs with checkpoints: ``eval/run.py`` and ``eval/run_emd.py``
with ``load:`` / ``load_encoder:`` of reference ``.pth`` files and of the
port's own directories, held to the JAX CLIs' loading
(``load_model_for_eval``, ``resolve_checkpoint_variables``) and evaluation on
the same episodes: per-episode accuracies bit-identical, ``--sauc`` AUCs
equal to JAX ``sauc_eval``'s. Then the train -> score loop the port could not
close before: ``train.meta_tune`` for one epoch, scored by ``eval/run.py``
from its ``max-va``."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.core.config import load_config as j_load_config
from fewshot_vit_tpu.core.registry import models as j_models
from fewshot_vit_tpu.data.datasets import synthetic_local as j_synthetic_local
from fewshot_vit_tpu.eval.emd_eval import (
    group_episode_indices as j_group,
    make_emd_eval_run_fn as j_run_fn,
)
from fewshot_vit_tpu.eval.episodic import evaluate as j_evaluate
from fewshot_vit_tpu.eval.run import load_model_for_eval as j_load_model_for_eval
from fewshot_vit_tpu.eval.run import sauc_eval as j_sauc_eval
from fewshot_vit_tpu.heads.deepemd import DeepEMD as JDeepEMD
from fewshot_vit_tpu.heads.meta_baseline import MetaBaseline as JMetaBaseline
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.ops.metric import roc_auc as j_roc_auc
from fewshot_vit_tpu.train.meta_tune_emd import (
    make_emd_episode_fn as j_episode_fn,
    make_patch_fn as j_patch_fn,
)
from fewshot_vit_tpu.train.runner import resolve_checkpoint_variables as j_resolve
from fewshot_vit_tpu_torch.checkpoint import from_flax, save_variables
from fewshot_vit_tpu_torch.core.rng import DEFAULT_SEED
from fewshot_vit_tpu_torch.data.datasets import synthetic, synthetic_local
from fewshot_vit_tpu_torch.eval import run, run_emd
from fewshot_vit_tpu_torch.eval.emd_eval import sample_emd_episode_indices
from fewshot_vit_tpu_torch.eval.episodic import evaluate
from fewshot_vit_tpu_torch.heads.deepemd import DeepEMD as TDeepEMD
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.ops.metric import roc_auc
from fewshot_vit_tpu_torch.train import meta_tune
from fewshot_vit_tpu_torch.train.runner import parse_args

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
NAME = "visformer_micro_80"
N_EP = 8  # one batch of the CLI's 8 episodes
DATA = dict(n_classes=6, n_per_class=20, image_size=80, seed=2)
ENC_ARGS = "{init_channels: 16, embed_dim: 96, depth: [1, 1, 1]}"
# SUN-D: 3-way 1-shot 2-query, 4 episodes in batches of 2
EMD_WAY, EMD_QUERY, EMD_EP, EMD_EPB = 3, 2, 4, 2


@pytest.fixture(scope="module", autouse=True)
def narrow_jax_visformer():
    """The JAX registry's ``visformer_micro_80`` fixes its widths; for the
    JAX CLIs' own loaders to build the narrow test encoder, the name takes
    the config's ``encoder_args`` over ``SMALL_VISFORMER`` in this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(j_models._ctors, NAME, lambda **kw: JVisformer(**{**SMALL_VISFORMER, **kw}))
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX MetaBaseline variables and, from them, a reference-format head
    ``.pth``, the same head as a port directory, and a SUN-D ``params``
    file of the DeepEMD head around the same encoder."""
    tmp = tmp_path_factory.mktemp("cli")
    jhead = JMetaBaseline(encoder=JVisformer(**SMALL_VISFORMER))
    xs0 = jnp.zeros((1, 2, 1, 80, 80, 3), jnp.float32)
    xq0 = jnp.zeros((1, 2, 80, 80, 3), jnp.float32)
    variables = randomize_bn(numpy_tree(jhead.init(jax.random.key(1), xs0, xq0)))
    variables["params"]["temp"] = np.asarray(12.0, np.float32)
    sd = from_flax(variables)
    paths = {"head_pth": str(tmp / "max-va.pth"), "head_dir": str(tmp / "port-max-va"),
             "sund_pth": str(tmp / "max_acc.pth"), "emd_dir": str(tmp / "emd-max-va")}
    torch.save({"model": "meta-baseline", "model_args": {"encoder": NAME}, "model_sd": sd},
               paths["head_pth"])
    save_variables(paths["head_dir"], sd, {"model": "meta-baseline", "encoder": NAME})
    enc_sd = {k: v for k, v in sd.items() if k.startswith("encoder.")}
    torch.save({"params": {"module." + k: v for k, v in enc_sd.items()}}, paths["sund_pth"])
    # a DeepEMD head that carries a pretrain classifier fc, saved by the port
    emd = TDeepEMD(TVisformer(**SMALL_VISFORMER, device="cpu"), n_classes=7)
    emd.encoder.load_state_dict({k[len("encoder."):]: v for k, v in enc_sd.items()})
    save_variables(paths["emd_dir"], emd.state_dict(), {"model": "deepemd", "encoder": NAME})
    return jhead, variables, paths, tmp


def _cfg(tmp, name, text):
    path = tmp / f"{name}.yaml"
    path.write_text(text)
    return str(path)


def _eval_cfg(tmp, name, load_line):
    return _cfg(tmp, name, "dataset: synthetic-local\n"
                f"dataset_args: {DATA}\n".replace("'", "")
                + f"encoder: {NAME}\nmodel_args: {{encoder_args: {ENC_ARGS}}}\n" + load_line)


@pytest.fixture(scope="module")
def jax_accs(setup):
    """Per-episode accuracies of JAX ``evaluate`` on the CLI's episodes:
    with ``load_model_for_eval``'s variables where JAX reads the checkpoint
    (the ``.pth`` files), else with the variables the directory was made
    from."""
    jhead, variables, paths, tmp = setup
    jds = j_synthetic_local(**DATA)
    out = {}
    for kind, line in (("head_pth", f"load: {paths['head_pth']}\n"),
                       ("encoder_pth", f"load_encoder: {paths['head_pth']}\n")):
        jh, jv = j_load_model_for_eval(j_load_config(_eval_cfg(tmp, "j" + kind, line)))
        out[kind] = np.asarray(j_evaluate(jh, jv, jds, n_episodes=N_EP, ep_per_batch=8,
                                          seed=DEFAULT_SEED)[2])
    out["head_dir"] = np.asarray(j_evaluate(jhead, variables, jds, n_episodes=N_EP,
                                            ep_per_batch=8, seed=DEFAULT_SEED)[2])
    return out


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "fold_bn"])
@pytest.mark.parametrize("kind", ["head_pth", "head_dir", "encoder_pth"])
def test_run_cli_loads_and_matches_jax(setup, jax_accs, capsys, kind, fold):
    _, _, paths, tmp = setup
    key, src = {"head_pth": ("load", "head_pth"), "head_dir": ("load", "head_dir"),
                "encoder_pth": ("load_encoder", "head_pth")}[kind]
    cfg = _eval_cfg(tmp, kind, f"{key}: {paths[src]}\n")
    accs = run.main(["--config", cfg, "--episodes", str(N_EP), "--device", "cpu"]
                    + (["--fold-bn"] if fold else []))
    out = capsys.readouterr().out
    assert "WARNING" not in out and "test epoch 1: acc=" in out
    want = jax_accs[kind]
    assert want.shape == (N_EP,) and 0 < want.mean() < 1  # a non-trivial protocol
    np.testing.assert_array_equal(accs, want)


def test_sauc_matches_jax(setup, capsys):
    _, _, paths, tmp = setup
    cfg = _eval_cfg(tmp, "sauc", f"load: {paths['head_pth']}\n")
    aucs = run.main(["--config", cfg, "--sauc", "--episodes", str(N_EP), "--device", "cpu"])
    jh, jv = j_load_model_for_eval(j_load_config(cfg))
    _, _, want = j_sauc_eval(jh, jv, j_synthetic_local(**DATA), N_EP, 1, seed=DEFAULT_SEED)
    assert aucs.shape == (N_EP,) and len(set(want.tolist())) > 1
    np.testing.assert_array_equal(aucs, want)
    assert "test epoch 1: acc=" in capsys.readouterr().out


@pytest.mark.parametrize("scores, labels", [
    ([0.1, 0.4, 0.35, 0.8], [0, 0, 1, 1]),
    ([0.5, 0.5, 0.5, 0.5], [1, 0, 1, 0]),            # all tied: 0.5
    ([0.2, 0.7, 0.7, 0.7, 0.1, 0.9], [0, 1, 0, 1, 0, 1]),  # a three-way tie across classes
    ([3.0, 1.0, 2.0], [1, 1, 1]),                    # one class absent: NaN
])
def test_roc_auc_matches_jax(scores, labels):
    np.testing.assert_array_equal(roc_auc(scores, labels), j_roc_auc(scores, labels))


def test_eval_refuses_unported_flags(setup):
    """``--mesh-data`` is ported (``tests/test_torch_mesh.py``) and keeps
    JAX's checks: one process is no mesh of 4, and the flag is refused with
    ``--cached`` or ``--sauc``; ``--int8`` is ported
    (``tests/test_torch_quant.py`` holds it to the JAX CLI)."""
    _, _, paths, tmp = setup
    cfg = _eval_cfg(tmp, "flags", f"load: {paths['head_pth']}\n")
    with pytest.raises(ValueError, match=r"mesh \{'data': 4\} needs 4 devices, have 1"):
        run.main(["--config", cfg, "--device", "cpu", "--mesh-data", "4"])
    for flag in ("--cached", "--sauc"):
        with pytest.raises(SystemExit):
            run.main(["--config", cfg, "--device", "cpu", "--mesh-data", "4", flag])


def _emd_cfg(tmp, name, mode, load_line):
    return _cfg(tmp, name, "val_dataset: synthetic-local\n"
                f"val_dataset_args: {DATA}\n".replace("'", "")
                + f"deepemd: {mode}\nway: {EMD_WAY}\nquery: {EMD_QUERY}\n"
                f"model_args: {{encoder: {NAME}, encoder_args: {ENC_ARGS}}}\n" + load_line)


@pytest.mark.parametrize("kind, mode", [("encoder_pth", "grid"), ("encoder_pth", "fcn"),
                                        ("emd_dir", "grid"), ("sund_pth", "grid")])
def test_run_emd_cli_loads_and_matches_jax(setup, capsys, kind, mode):
    """``load_encoder:`` a head ``.pth`` (grid and fcn); ``load:`` a port
    directory whose DeepEMD head carries a pretrain ``fc`` (dropped: the
    episodic head has none); ``load:`` a SUN-D ``{"params": {"module.…"}}``
    file through the head rule. JAX's variables come from its own
    ``resolve_checkpoint_variables`` where it reads the file."""
    jhead_mb, variables, paths, tmp = setup
    line = {"encoder_pth": f"load_encoder: {paths['head_pth']}\n",
            "emd_dir": f"load: {paths['emd_dir']}\n",
            "sund_pth": f"load: {paths['sund_pth']}\n"}[kind]
    cfg = _emd_cfg(tmp, f"emd_{kind}_{mode}", mode, line)
    accs = run_emd.main(["--config", cfg, "--episodes", str(EMD_EP), "--ep-per-batch",
                         str(EMD_EPB), "--device", "cpu"])
    assert "WARNING" not in capsys.readouterr().out

    jhead = JDeepEMD(encoder=JVisformer(**SMALL_VISFORMER))
    init = numpy_tree(jhead.init(jax.random.key(3), jnp.zeros((1, 80, 80, 3), jnp.float32)))
    if kind == "emd_dir":  # the port's directory: JAX gets the tree it was made from
        jvars = {col: dict(tree, encoder=variables[col]["encoder"]) for col, tree in init.items()}
    else:
        jvars = j_resolve(j_load_config(cfg), jhead, init, NAME)
        jax.tree_util.tree_map(np.testing.assert_array_equal, jvars["params"]["encoder"],
                               variables["params"]["encoder"])
    jds = j_synthetic_local(**DATA)
    idx = sample_emd_episode_indices(synthetic_local(**DATA), EMD_EP, EMD_WAY, 1 + EMD_QUERY,
                                     DEFAULT_SEED)
    ep_fn = j_episode_fn(jhead, EMD_WAY, 1, EMD_QUERY, j_patch_fn(mode, [2, 3], 9, 2.0, 80, False),
                         jds.mean, jds.std, sfc=False)
    want = np.asarray(j_run_fn(ep_fn, jnp.tile(jnp.arange(EMD_WAY), EMD_QUERY))(
        jvars, jnp.asarray(jds.images), jnp.asarray(j_group(idx, EMD_EPB)),
        jax.random.key(0)))[:EMD_EP]
    assert accs.shape == (EMD_EP,)
    np.testing.assert_array_equal(accs, want)


TRAIN_CONFIG = """
train_dataset: synthetic
train_dataset_args: {n_classes: 6, n_per_class: 8, image_size: 32, seed: 2}
val_dataset: synthetic
val_dataset_args: {n_classes: 5, n_per_class: 16, image_size: 32, seed: 3}
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
max_epoch: 1
optimizer: sgd
optimizer_args: {lr: 1.e-2, weight_decay: 5.e-4, milestones: [1], gamma: 0.5}
val_episodes: 4
"""


def test_meta_tune_checkpoint_scored_by_the_eval_cli(tmp_path, capsys):
    """The port trains a model and scores it with its own eval CLI: one
    epoch of ``train.meta_tune``, then ``eval/run.py`` with ``load:`` on its
    ``max-va`` prints the accuracy that ``evaluate`` of the trained head
    gives in process on the same episodes."""
    cfg = tmp_path / "train.yaml"
    cfg.write_text(TRAIN_CONFIG)
    state = meta_tune.main(*parse_args("test", ["--config", str(cfg), "--save-root",
                                                str(tmp_path), "--name", "run", "--device",
                                                "cpu"]))
    head = state.module.eval()
    ds = synthetic(n_classes=5, n_per_class=16, image_size=32, seed=3)
    m, h, want = evaluate(head, ds, n_episodes=N_EP, ep_per_batch=8, seed=DEFAULT_SEED,
                          device="cpu")
    capsys.readouterr()
    eval_cfg = tmp_path / "eval.yaml"
    eval_cfg.write_text(
        "dataset: synthetic\n"
        "dataset_args: {n_classes: 5, n_per_class: 16, image_size: 32, seed: 3}\n"
        "model_args: {encoder: visformer_micro_80, encoder_args: {img_size: 32,\n"
        "             init_channels: 8, embed_dim: 48, depth: [1, 1, 1], drop_path_rate: 0.5}}\n"
        f"load: {tmp_path / 'run' / 'max-va'}\n")
    accs = run.main(["--config", str(eval_cfg), "--episodes", str(N_EP), "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"test epoch 1: acc=(\S+) \+- (\S+) \(%\)", out).groups() == (
        f"{m * 100:.2f}", f"{h * 100:.2f}")
    np.testing.assert_array_equal(accs, want)
    assert head.temp.item() != 10.0  # the learned temperature went through the directory
