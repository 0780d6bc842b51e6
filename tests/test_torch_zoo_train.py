"""Port parity, the encoder zoo in training mode: per family, one forward and
backward of a CE loss with batch-statistics BN and JAX's own drop-path,
dropout and DropBlock draws replayed in the port (``injected_draws``): the
loss within 1e-4 relative, every parameter's gradient within 1e-3 of its
max-abs, the updated BN statistics (and resnet12-drop's batch counters)
within 1e-5. Then one pretrain step of a narrow LeViT and a narrow NesT
against the JAX pretrain step (rates 0, SGD): loss 1e-4, parameters 2e-5,
BN statistics 1e-5."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from fewshot_vit_tpu.heads import classifier as jc
from fewshot_vit_tpu.train import loop as jloop
from fewshot_vit_tpu.train.optim import make_optimizer as j_make_optimizer
from fewshot_vit_tpu.train.state import TrainState as JTrainState
from fewshot_vit_tpu_torch.checkpoint import from_flax, load_flax
from fewshot_vit_tpu_torch.core import rng as t_rng
from fewshot_vit_tpu_torch.data.datasets import synthetic
from fewshot_vit_tpu_torch.heads.classifier import make_classifier
from fewshot_vit_tpu_torch.models import common as tc
from fewshot_vit_tpu_torch.train import loop as tloop
from fewshot_vit_tpu_torch.train.optim import make_optimizer
from fewshot_vit_tpu_torch.train.state import TrainState

from .test_torch_zoo import CASES, assert_rel_close, case_models, case_setup, draw_variables
from .torch_port_helpers import numpy_tree

torch.set_num_threads(1)
LOSS_TOL, GRAD_TOL, BN_TOL = 1e-4, 1e-3, 1e-5

# one case per family, with its stochastic layers switched on
TRAIN_CASES = {
    "nest_gpsa": dict(drop_path_rate=0.4),
    "swin_3conv": dict(drop_path_rate=0.4),
    "levit": dict(drop_path_rate=0.5),  # one drop-path module for every residual
    "lvvit": dict(drop_path_rate=0.4),
    "deit": dict(drop_path_rate=0.4),
    "resnet_basic": {},
    "resnet12": {},
    "resnet12_drop": dict(drop_rate=0.1),
    "convnet4": {},
}

# biases whose only way to the loss is through a batch-statistics BN, which
# removes them (convnet4's conv biases; the output bias of LeViT's first
# subsample, a constant shift of the stream the next subsample's q and kv
# normalize away): their true gradient is 0 (1e-16 in float64), both
# packages give fp32 rounding noise, held to 1e-3 of the model's largest
# gradient instead of their own
ZERO_GRAD = {"convnet4": r"encoder\.\d\.0\.bias", "levit": r"blocks\.2\.proj\.1\.bn\.bias"}


def _recording_bernoulli(drawn):
    orig = jax.random.bernoulli

    def record(*args, **kwargs):
        mask = orig(*args, **kwargs)
        drawn.append(mask)
        return mask

    return orig, record


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_forward_and_gradients_match_jax(case):
    x, variables, jm, port = case_setup(case, seed=3, batch=4, **TRAIN_CASES[case])
    if case == "resnet12_drop":
        # past the keep-rate ramp, so DropBlock really drops
        for layer in variables["batch_stats"].values():
            layer["num_batches_tracked"] = np.asarray(40000.0, np.float32)
        port = load_flax(port, variables)
    head_w = np.random.default_rng(4).normal(0, 0.2, (port.out_dim, 5)).astype(np.float32)
    labels = np.array([0, 3, 1, 4])

    def loss_fn(params):
        drawn = []
        orig, record = _recording_bernoulli(drawn)
        jax.random.bernoulli = record
        try:
            (dense, pooled), mut = jm.apply(
                {**variables, "params": params}, jnp.asarray(x), train=True,
                mutable=["batch_stats"],
                rngs={"dropout": jax.random.key(1), "droppath": jax.random.key(2)})
        finally:
            jax.random.bernoulli = orig
        logits = pooled @ jnp.asarray(head_w)
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()
        return loss, (dense, mut.get("batch_stats", {}), drawn)

    (j_loss, (j_dense, j_stats, drawn)), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    masks = [torch.from_numpy(np.array(m)) for m in drawn]
    assert masks or not TRAIN_CASES[case]  # the stochastic layers drew
    assert any(not m.all() for m in masks) or not masks  # and dropped something

    port.train()
    with tc.injected_draws(masks):
        dense, pooled = port(torch.from_numpy(x))
    loss = F.cross_entropy(pooled @ torch.from_numpy(head_w), torch.from_numpy(labels))
    loss.backward()

    assert abs(loss.item() - float(j_loss)) <= LOSS_TOL * abs(float(j_loss))
    # batch-statistics BN over few values: both fp32 forwards are ~5e-5 of
    # max-abs off the float64 one (LeViT), so the map is held to 1e-4 of it
    assert_rel_close(dense.detach().numpy(), j_dense, 1e-4, "dense")
    want = from_flax({"params": numpy_tree(j_grads)}, like=port)
    got = {k: p.grad for k, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    top = max(v.abs().max().item() for v in want.values())
    for k, g in got.items():
        err = (g - want[k]).abs().max().item()
        if case in ZERO_GRAD and re.fullmatch(ZERO_GRAD[case], k):
            assert max(g.abs().max().item(), want[k].abs().max().item()) <= GRAD_TOL * top, (
                k, g.abs().max().item(), want[k].abs().max().item(), top)
            continue
        assert err <= GRAD_TOL * want[k].abs().max().item() + 1e-6, (k, err)
    assert_stats_close(port.state_dict(), from_flax({"batch_stats": numpy_tree(j_stats)},
                                                    like=port))


def assert_stats_close(got, want):
    """BN statistics within 1e-5. The batch variance is E[x^2] - E[x]^2 in
    both packages (flax's fast variance), so its rounding scales with the
    second moment: a running_var is held to 1e-5 of running_mean^2 +
    running_var, not of itself."""
    for k, v in want.items():
        tol = BN_TOL
        if k.endswith("running_var"):
            tol = BN_TOL * (want[k[:-3] + "mean"] ** 2 + v).max().item()
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=BN_TOL, atol=tol, err_msg=k)


def test_frozen_bn_counts_no_batches_and_keeps_stats():
    _, variables, _, port = case_setup("resnet12_drop", drop_rate=0.1)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port.train()
    with tc.frozen_bn(), tc.draws_from(torch.Generator().manual_seed(0)):
        port(torch.zeros(2, 80, 80, 3))
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    port(torch.zeros(2, 80, 80, 3))
    assert port.layer1[0].num_batches_tracked.item() == 1.0


def test_injected_draw_of_wrong_shape_raises():
    dp = tc.DropPath(0.5).train()
    with tc.injected_draws([torch.ones(3, 1, 1, 1, dtype=torch.bool)]):
        with pytest.raises(ValueError, match="injected draw of shape"):
            dp(torch.ones(2, 4, 4, 3))


# SGD: the update is linear in the gradient. LeViT's gradients reach ~10 and
# both packages' fp32 ones are up to 4e-4 of max-abs off the float64 one
# (LinearNorm's batch-statistics BN; the stem's, ROADMAP.md section 3, up to
# 6e-3), so lr 1e-3 keeps that under 2e-5
N_CLASSES, BATCH, LR, WD = 5, 8, 1e-3, 5e-4
STEP_CASES = {"levit": "levit_micro_80", "nest_gpsa": "nest_micro_v2_gpsa"}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_pretrain_step_matches_jax(case):
    """One step of the pretrain epoch (SGD, rates 0) on a narrow encoder: the
    JAX package's ``make_pretrain_epoch`` and the port's, from the same
    weights and batch."""
    ds = synthetic(n_classes=N_CLASSES, n_per_class=2, image_size=80, seed=2)
    jenc, _ = case_models(case)
    jmodel = jc.Classifier(encoder=jenc, classifier=jc.LinearClassifier(N_CLASSES,
                                                                        name="classifier"))
    variables = draw_variables(jmodel, np.zeros((1, 80, 80, 3), np.float32))
    idx = tloop.batch_indices(len(ds), BATCH, t_rng.np_rng(5, 1))[:1]

    tx = j_make_optimizer(variables["params"], "sgd", lr=LR, weight_decay=WD)
    jstate = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    j_epoch = jloop.make_pretrain_epoch(jmodel, tx, mean=ds.mean, std=ds.std)
    jstate, j_ms = j_epoch(jstate, jnp.asarray(ds.images), jnp.asarray(ds.labels),
                           jnp.asarray(idx), jax.random.key(0))

    cls, kw, _ = CASES[case]
    model = make_classifier(STEP_CASES[case], encoder_args={**kw, "drop_path_rate": 0.0},
                            classifier_args={"n_classes": N_CLASSES}, device="cpu")
    load_flax(model, variables)
    state = TrainState(model, make_optimizer(model.parameters(), "sgd", lr=LR, weight_decay=WD))
    ms = tloop.make_pretrain_epoch(None, ds.mean, ds.std)(
        state, torch.from_numpy(ds.images), torch.from_numpy(ds.labels.astype(np.int64)),
        torch.from_numpy(idx.astype(np.int64)), (5, 1))
    np.testing.assert_allclose(ms["loss"].numpy(), np.asarray(j_ms["loss"]), rtol=0, atol=1e-4)
    want = {**from_flax({"params": numpy_tree(jstate.params)}, like=model),
            **from_flax({"batch_stats": numpy_tree(jstate.batch_stats)}, like=model)}
    got = state.variables
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if "running" not in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=2e-5, err_msg=k)
    assert_stats_close(got, {k: v for k, v in want.items() if "running" in k})
