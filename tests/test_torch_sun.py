"""Port parity, phase 2 (SUN): a 3-step trajectory of the SUN step against the
JAX package's (fp32 teacher), the teacher assembled from a phase-1
checkpoint, the teacher's fused attention inside a training step, the
teacher's one relayout of the dual view's weak view, and the CLI on
``--device cpu`` loading the pretrain CLI's ``max-va``.

The trajectory: a narrow Visformer at img 80 (stage 2 has T = 100 tokens, so
the teacher's attention meets the fused kernel's dispatch rule; on the CPU
the kernel's plain version runs), the same student and teacher weights
(non-trivial BN statistics), the same batches, drop rates 0 and plain
normalization; per-step loss, cls_loss and token_loss within 1e-4,
parameters within 2e-5, BN statistics within 1e-5. SGD, as in
``test_torch_pretrain.py``. (With another batch draw, np_rng(5, 1), one
stem tensor ends 2.5e-5 off, in fp32 and in float64 alike: a discrete
difference, most likely a max-pool window of the stem whose two largest
inputs lie 1.7e-6 apart at step 3, ``ROADMAP.md`` section 3.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.heads.token_label import TokenLabel as JTokenLabel
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.train import loop as jloop
from fewshot_vit_tpu.train.optim import make_optimizer as j_make_optimizer
from fewshot_vit_tpu.train.state import TrainState as JTrainState
from fewshot_vit_tpu.train.sun import assemble_teacher_variables as j_assemble
from fewshot_vit_tpu_torch.checkpoint import from_flax, load_flax
from fewshot_vit_tpu_torch.core import rng as t_rng
from fewshot_vit_tpu_torch.core import trace
from fewshot_vit_tpu_torch.data.augment import make_dual_view_fn
from fewshot_vit_tpu_torch.data.datasets import synthetic
from fewshot_vit_tpu_torch.heads.classifier import make_classifier
from fewshot_vit_tpu_torch.heads.token_label import TokenLabel
from fewshot_vit_tpu_torch.kernels import attention as attn_mod
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.train import loop as tloop
from fewshot_vit_tpu_torch.train import pretrain, runner, sun
from fewshot_vit_tpu_torch.train.optim import make_optimizer
from fewshot_vit_tpu_torch.train.state import TrainState
from fewshot_vit_tpu_torch.train.steps import make_sun_step

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn
from .test_torch_pretrain import CLI_CONFIG as PRETRAIN_CLI

torch.set_num_threads(1)
N_CLASSES, BATCH, STEPS, LR, WD = 6, 4, 3, 0.05, 5e-4
SUN_KW = dict(soft_k=3, bg_tokens=10, token_weight=0.5)


@pytest.fixture(scope="module")
def setup():
    ds = synthetic(n_classes=N_CLASSES, n_per_class=2, image_size=80, seed=2)
    jmodel = JTokenLabel(encoder=JVisformer(**SMALL_VISFORMER), n_classes=N_CLASSES)
    x = jnp.zeros((1, 80, 80, 3))
    sv = randomize_bn(numpy_tree(jmodel.init(jax.random.key(1), x)), seed=3)
    tv = randomize_bn(numpy_tree(jmodel.init(jax.random.key(2), x)), seed=4)
    idx = tloop.batch_indices(len(ds), BATCH, t_rng.np_rng(6, 1))[:STEPS]
    return ds, jmodel, sv, tv, idx


def _token_label(variables, fused=False):
    enc = TVisformer(**SMALL_VISFORMER, use_pallas_attn=fused, device="cpu")
    return load_flax(TokenLabel(enc, N_CLASSES), variables)


def test_sun_trajectory_matches_jax(setup):
    ds, jmodel, sv, tv, idx = setup
    tx = j_make_optimizer(sv["params"], "sgd", lr=LR, weight_decay=WD)
    jstate = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, sv), tx)
    j_epoch = jloop.make_sun_epoch(jmodel, jmodel, tx, mean=ds.mean, std=ds.std, **SUN_KW)
    jstate, j_ms = j_epoch(jstate, jax.tree_util.tree_map(jnp.asarray, tv),
                           jnp.asarray(ds.images), jnp.asarray(ds.labels), jnp.asarray(idx),
                           jax.random.key(0))

    student, teacher = _token_label(sv), _token_label(tv, fused=True)
    teacher.requires_grad_(False)
    start = {k: v.clone() for k, v in student.state_dict().items()}
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    state = TrainState(student, make_optimizer(student.parameters(), "sgd", lr=LR, weight_decay=WD))
    ms = tloop.make_sun_epoch(None, ds.mean, ds.std, **SUN_KW)(
        state, teacher, torch.from_numpy(ds.images), torch.from_numpy(ds.labels.astype(np.int64)),
        torch.from_numpy(idx.astype(np.int64)), (6, 1))
    assert state.step == STEPS and sorted(ms) == ["acc", "cls_loss", "loss", "token_loss"]
    for k in ms:
        np.testing.assert_allclose(ms[k].numpy(), np.asarray(j_ms[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(ms["loss"].numpy(),
                               (ms["cls_loss"] + 0.5 * ms["token_loss"]).numpy(), rtol=1e-6)
    got = state.variables
    want_p = from_flax({"params": numpy_tree(jstate.params)})
    want_s = from_flax({"batch_stats": numpy_tree(jstate.batch_stats)})
    assert sorted(got) == sorted({**want_p, **want_s})
    for k, v in want_p.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=2e-5, err_msg=k)
    for k, v in want_s.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
        assert not torch.equal(got[k], start[k]), k
    assert not torch.equal(got["classifier_local.linear.weight"],
                           start["classifier_local.linear.weight"])  # the token loss trains it
    for k, v in teacher.state_dict().items():  # the teacher is frozen, statistics too
        assert torch.equal(v, teacher_before[k]), k


def test_teacher_attention_goes_through_the_kernel_wrapper(setup, monkeypatch):
    """Inside a training step the eval-mode teacher calls ``fused_mhsa`` once
    per stage-2 block, under ``no_grad``; the training-mode student never
    does (it stays on the einsum path)."""
    ds, _, sv, tv, idx = setup
    calls = []
    real = attn_mod.fused_mhsa

    def spy(q, *args, **kw):
        calls.append((q.shape, torch.is_grad_enabled()))
        return real(q, *args, **kw)

    monkeypatch.setattr(attn_mod, "fused_mhsa", spy)
    student = _token_label(sv, fused=True)
    teacher = _token_label(tv, fused=True).requires_grad_(False)
    state = TrainState(student, make_optimizer(student.parameters(), "sgd", lr=LR))
    step = make_sun_step(mean=ds.mean, std=ds.std, **SUN_KW)
    imgs = torch.from_numpy(ds.images[idx[0]])
    step(state, teacher, imgs, imgs, torch.from_numpy(ds.labels[idx[0]]), (5, 1, 0))
    heads, hd = SMALL_VISFORMER["num_heads"], SMALL_VISFORMER["embed_dim"] // 6
    assert calls == [((BATCH, heads, 100, hd), False)] * len(teacher.encoder.stage2)
    assert student.training and not teacher.training


def test_dual_view_step_relayouts_the_weak_view_once_in_the_teacher(setup):
    """The dual view's weak view (the teacher's input) comes out of the crop's
    resample with H and W swapped in memory (unless a RandAugment layer
    rewrites it, as Rotate does; not at this key): the teacher's encoder
    copies it to NHWC once; the strong view is contiguous, so the student
    copies nothing."""
    ds, _, sv, tv, idx = setup
    student = _token_label(sv)
    teacher = _token_label(tv).requires_grad_(False)
    state = TrainState(student, make_optimizer(student.parameters(), "sgd", lr=LR))
    step = make_sun_step(dual_view_fn=make_dual_view_fn(ds.mean, ds.std, out_size=80), **SUN_KW)
    imgs = torch.from_numpy(ds.images[idx[0]])
    trace.reset()
    trace.enable()
    try:
        step(state, teacher, imgs, imgs, torch.from_numpy(ds.labels[idx[0]]), (5, 1, 0))
    finally:
        trace.disable()
        snap = trace.reset()
    spans = snap["spans"]
    assert len(spans["train.teacher"]) == len(spans["train.student"]) == 1
    assert spans["train.teacher"][0]["counts"].get("encoder.relayout") == 1
    assert spans["train.student"][0]["counts"].get("encoder.relayout", 0) == 0
    assert snap["counters"]["encoder.relayout"] == 1


def test_assemble_teacher_from_a_classifier_checkpoint():
    """Encoder and global classifier come from the phase-1 checkpoint,
    ``classifier_local`` keeps its initialization, as in the JAX package."""
    clf = make_classifier("visformer_micro_80", encoder_args=SMALL_VISFORMER,
                          classifier_args={"n_classes": N_CLASSES}, device="cpu", seed=3)
    ck = clf.state_dict()
    teacher = TokenLabel(TVisformer(**SMALL_VISFORMER, device="cpu"), N_CLASSES)
    local = teacher.classifier_local.linear.weight.detach().clone()
    sun.assemble_teacher_variables(teacher, ck)
    for k, v in ck.items():
        assert torch.equal(teacher.state_dict()[k], v), k
    assert torch.equal(teacher.classifier_local.linear.weight, local)
    x = torch.randn(2, 80, 80, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(teacher(x, is_teacher=True)[1], clf(x), rtol=0, atol=0)
    with pytest.raises(KeyError, match="no place"):
        sun.assemble_teacher_variables(TokenLabel(TVisformer(**SMALL_VISFORMER, device="cpu"),
                                                  N_CLASSES + 1), ck)
    # the JAX function on the same structure: only encoder and classifier move
    out = j_assemble({"params": {"encoder": 1, "classifier": 2, "classifier_local": 3}},
                     {"params": {"encoder": 10, "classifier": 20}})
    assert out == {"params": {"encoder": 10, "classifier": 20, "classifier_local": 3}}


SUN_CLI = """
train_dataset: synthetic
train_dataset_args: {n_classes: 6, n_per_class: 8, image_size: 36, seed: 2}
fs_dataset: synthetic
fs_dataset_args: {n_classes: 5, n_per_class: 20, image_size: 32, seed: 4}
model: token-label
model_args:
  encoder: visformer_micro_80
  encoder_args: {init_channels: 8, embed_dim: 48, depth: [1, 1, 1], drop_path_rate: 0.1,
                 use_pallas_attn: true}
load: %s
bg_token_num: 1
batch_size: 16
max_epoch: %d
optimizer: adamw
optimizer_args: {lr: 5.e-4, schedule: cosine, warmup_epochs: 0}
eval_fs_epoch: 1
eval_fs_episodes: 4
image_size: 32
teacher_dtype: %s
%s
"""


def test_cli_chain_pretrain_then_sun_on_cpu(tmp_path, capsys):
    """The pretrain CLI's max-va becomes the SUN teacher (and the student's
    start); two SUN epochs, then a resumed third."""
    pre = tmp_path / "pre.yaml"
    pre.write_text(PRETRAIN_CLI % (2, "adamw", 0, ""))
    pretrain.main(*runner.parse_args("t", ["--config", str(pre), "--save-root", str(tmp_path),
                                           "--name", "pre", "--device", "cpu"]))
    best = tmp_path / "pre" / "max-va"
    cfg = tmp_path / "sun.yaml"
    cfg.write_text(SUN_CLI % (best, 2, "float32", ""))
    argv = ["--config", str(cfg), "--save-root", str(tmp_path), "--name", "sun", "--device", "cpu"]
    capsys.readouterr()
    state = sun.main(*runner.parse_args("t", argv))
    out = capsys.readouterr().out
    assert "epoch 1 loss=" in out and "cls=" in out and "token=" in out and "fsa-1=" in out
    assert "WARNING" not in out and state.step == 6
    run = tmp_path / "sun"
    for name in ("epoch-last", "max-va", "resume"):
        assert (run / name / "arrays.pt").is_file(), name
    saved, _ = sun.load_variables(str(best))
    assert not torch.equal(state.module.state_dict()["encoder.pos_embed1"],
                           saved["encoder.pos_embed1"])  # it started there and moved

    cfg.write_text(SUN_CLI % (best, 3, "bfloat16", "resume: true"))
    resumed = sun.main(*runner.parse_args("t", argv))
    out = capsys.readouterr().out
    assert "resumed full train state from epoch 2" in out and "epoch 3 loss=" in out
    assert "epoch 2 " not in out and resumed.step == 9

    cfg.write_text((SUN_CLI % ("null", 1, "float32", "augment: none")).replace(
        "image_size: 36", "image_size: 32"))
    sun.main(*runner.parse_args("t", argv[:-3] + ["scratch", "--device", "cpu"]))
    assert "teacher is randomly initialized" in capsys.readouterr().out


def test_cli_writes_the_dataset_and_dual_view_grids(tmp_path):
    """``visualize_datasets: true``: a grid per split and both SUN views."""
    cfg = tmp_path / "c.yaml"
    cfg.write_text(SUN_CLI % ("null", 1, "float32", "visualize_datasets: true"))
    sun.main(*runner.parse_args("t", ["--config", str(cfg), "--device", "cpu", "--name", "run",
                                      "--save-root", str(tmp_path / "s")]))
    pngs = sorted(p.name for p in (tmp_path / "s" / "run").glob("*.png"))
    assert pngs == ["visualize_fs_dataset.png", "visualize_train_dataset.png",
                    "visualize_train_strong.png", "visualize_train_weak.png"]


def test_cli_defaults_to_the_card_and_refuses_auxiliaries(tmp_path, monkeypatch):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(SUN_CLI % ("null", 1, "float32", "mesh: {data: 4}"))
    with pytest.raises(ValueError, match=r"mesh \{'data': 4\} needs 4 devices, have 1"):
        sun.main(*runner.parse_args("t", ["--config", str(cfg), "--device", "cpu",
                                          "--save-root", str(tmp_path / "s")]))
    assert not (tmp_path / "s").exists()  # refused before a run directory is made
    cfg.write_text(SUN_CLI % ("null", 1, "float32", ""))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c, args = runner.parse_args("t", ["--config", str(cfg), "--save-root", str(tmp_path / "s")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sun.main(c, args)
    assert not (tmp_path / "s").exists()
