"""Port parity, training mode: batch-statistics BN and its running updates,
``frozen_bn``, DropPath / Dropout, the drop-path ladder, and a narrow
Visformer's ``train=True`` forward and parameter gradients against flax and
``jax.grad`` (JAX-initialized weights carried across with ``from_flax``;
random streams differ by construction, so the rates are 0 or the mask is
injected)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from fewshot_vit_tpu.models.common import BatchNorm as JBatchNorm
from fewshot_vit_tpu.models.common import frozen_bn as j_frozen_bn
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu_torch.checkpoint import from_flax, load_flax
from fewshot_vit_tpu_torch.kernels import attention as tk
from fewshot_vit_tpu_torch.models import common as tc
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.models.visformer import drop_path_ladder

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
TOL = 1e-4  # fp32 convs and GEMMs summed in another order by XLA:CPU and torch
BN_TOL = 1e-5


def _bn_pair(x, seed=1):
    rng = np.random.default_rng(seed)
    c = x.shape[-1]
    variables = {"params": {"bn": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                                   "bias": rng.normal(0, 0.3, c).astype(np.float32)}},
                 "batch_stats": {"bn": {"mean": rng.normal(0, 0.5, c).astype(np.float32),
                                        "var": rng.uniform(0.25, 4.0, c).astype(np.float32)}}}
    port = tc.BatchNorm(c)
    port.load_state_dict(from_flax(variables))
    return variables, port


def test_bn_training_forward_and_running_stats_match_flax():
    """The biased-variance test: flax updates ``var`` with the biased batch
    variance, ``torch.nn.BatchNorm2d`` with the unbiased one; the port follows
    flax. With 2*3*3 = 18 values per channel the two differ by 18/17."""
    x = np.random.default_rng(0).normal(1.0, 2.0, (2, 3, 3, 8)).astype(np.float32)
    variables, port = _bn_pair(x)
    want, mut = JBatchNorm().apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    port.train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=BN_TOL, atol=BN_TOL)
    new = mut["batch_stats"]["bn"]
    np.testing.assert_allclose(port.bn.running_mean.numpy(), np.asarray(new["mean"]),
                               rtol=BN_TOL, atol=BN_TOL)
    np.testing.assert_allclose(port.bn.running_var.numpy(), np.asarray(new["var"]),
                               rtol=BN_TOL, atol=BN_TOL)
    # and it is NOT torch's unbiased update
    ref = torch.nn.BatchNorm2d(8)
    ref.load_state_dict({**{k[3:]: v for k, v in from_flax(variables).items()},
                         "num_batches_tracked": torch.tensor(0)})
    ref.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert (ref.running_var - port.bn.running_var).abs().max() > 1e-3


def test_bn_eval_mode_leaves_stats_alone():
    x = np.random.default_rng(2).normal(size=(2, 3, 3, 8)).astype(np.float32)
    variables, port = _bn_pair(x)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    want = JBatchNorm().apply(variables, jnp.asarray(x), False)
    got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=BN_TOL, atol=BN_TOL)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_frozen_bn_is_eval_bn_with_dropout_still_live():
    x = np.random.default_rng(3).normal(size=(4, 3, 3, 8)).astype(np.float32)
    variables, port = _bn_pair(x)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with j_frozen_bn():
        want = JBatchNorm().apply(variables, jnp.asarray(x), True)
    port.train()
    with tc.frozen_bn():
        got = port(torch.from_numpy(x))
        assert tc.bn_uses_running_stats(True)
    assert not tc.bn_uses_running_stats(True)  # the context ended
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=BN_TOL, atol=BN_TOL)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    # dropout and drop-path stay stochastic inside the context
    drop, path = tc.Dropout(0.5).train(), tc.DropPath(0.5).train()
    ones = torch.ones(64, 2, 2, 4)
    with tc.frozen_bn(), tc.draws_from(torch.Generator().manual_seed(0)):
        assert 0 < (drop(ones) == 0).float().mean() < 1
        assert 0 < (path(ones) == 0).float().mean() < 1


def test_drop_path_injected_mask_and_eval_identity():
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(4, 2, 2, 3)).astype(np.float32))
    dp = tc.DropPath(0.25).train()
    mask = torch.tensor([True, False, True, True]).reshape(4, 1, 1, 1)
    got = dp(x, mask=mask)
    torch.testing.assert_close(got[0], x[0] / 0.75)
    assert not got[1].any()
    assert dp.eval()(x) is x
    assert tc.DropPath(0.0).train()(x) is x
    assert tc.Dropout(0.0).train()(x) is x


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_drop_path_keep_rate_and_scaling_over_many_draws(rate):
    dp = tc.DropPath(rate).train()
    x = torch.ones(20000, 1, 1, 2)
    with tc.draws_from(torch.Generator().manual_seed(1)):
        y = dp(x)
    kept = (y[:, 0, 0, 0] != 0)
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.015
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    assert (y[:, 0, 0, 0] == y[:, 0, 0, 1]).all()  # one draw per row
    assert abs(y.mean().item() - 1.0) < 0.03       # unbiased
    with tc.draws_from(torch.Generator().manual_seed(1)):
        assert torch.equal(dp(x), y)               # the generator decides


def test_drop_path_ladder_rates():
    assert drop_path_ladder(0.5, 9) == [0.5 * i / 8 for i in range(9)]
    assert drop_path_ladder(0.3, 1) == [0.0]
    model = TVisformer(**{**SMALL_VISFORMER, "depth": (2, 1, 2)}, drop_path_rate=0.4,
                       drop_rate=0.1, attn_drop_rate=0.2, device="cpu")
    blocks = [*model.stage1, *model.stage2, *model.stage3]
    assert [b.drop_path.rate for b in blocks] == pytest.approx([0.0, 0.1, 0.2, 0.3, 0.4])
    assert model.pos_drop.rate == 0.1 and blocks[0].mlp.drop.rate == 0.1
    assert blocks[2].attn.attn_dropout.rate == 0.2 and blocks[2].attn.proj_dropout.rate == 0.1


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(0).normal(size=(4, 80, 80, 3)).astype(np.float32)
    jm = JVisformer(**SMALL_VISFORMER)
    variables = randomize_bn(numpy_tree(jm.init(jax.random.key(0), jnp.asarray(x))))
    head_w = np.random.default_rng(1).normal(0, 0.2, (192, 5)).astype(np.float32)
    labels = np.array([0, 3, 1, 4])
    return x, variables, head_w, labels


def _j_loss(jm, variables, x, head_w, labels, frozen=False):
    def loss_fn(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if frozen:
            with j_frozen_bn():
                (dense, pooled), stats = jm.apply(v, x, train=True), variables["batch_stats"]
        else:
            (dense, pooled), mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
            stats = mut["batch_stats"]
        loss = optax.softmax_cross_entropy_with_integer_labels(pooled @ head_w, labels).mean()
        return loss, (dense, pooled, stats)
    return jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])


@pytest.mark.parametrize("frozen", [False, True])
def test_visformer_train_forward_and_gradients_match_jax(setup, frozen):
    """Rates 0. The forward within 1e-4; the gradient of a CE loss with
    respect to EVERY parameter within 1e-4 of that tensor's max-abs, the JAX
    gradients carried across by ``from_flax`` (a linear relabelling); the
    updated BN statistics within 1e-5."""
    x, variables, head_w, labels = setup
    jm = JVisformer(**SMALL_VISFORMER)
    (j_loss, (j_dense, j_pooled, j_stats)), j_grads = _j_loss(
        jm, variables, jnp.asarray(x), jnp.asarray(head_w), jnp.asarray(labels), frozen)

    port = load_flax(TVisformer(**SMALL_VISFORMER, device="cpu", use_pallas_attn=True),
                     variables).train()
    before = tk.fused_mhsa.launches
    calls = []
    orig = tk.attention_core
    import fewshot_vit_tpu_torch.models.visformer as tv
    tv_orig = tv.attention_core
    tv.attention_core = lambda *a, **k: calls.append(1) or tv_orig(*a, **k)
    try:
        if frozen:
            with tc.frozen_bn():
                dense, pooled = port(torch.from_numpy(x))
        else:
            dense, pooled = port(torch.from_numpy(x))
    finally:
        tv.attention_core = tv_orig
    # attention in training mode takes the einsum path whatever use_pallas_attn says
    assert not calls and tk.fused_mhsa.launches == before and orig is tv_orig
    loss = F.cross_entropy(pooled @ torch.from_numpy(head_w), torch.from_numpy(labels))
    loss.backward()

    np.testing.assert_allclose(dense.detach().numpy(), np.asarray(j_dense), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=TOL, atol=TOL)
    want = from_flax({"params": numpy_tree(j_grads)})
    got = {k: p.grad for k, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        # 1e-4 of the tensor's max-abs, over a floor of 1e-6 for the tensors
        # whose true gradient is 0 (a bias in front of a batch-statistics BN).
        # XLA:CPU's fp32 gradient through the STEM's batch-statistics BNs is
        # itself 6e-4 .. 6e-3 off the float64 gradient (the port's fp32 one is
        # 3e-6 off it; the float64 test below holds both to 1e-9), so those
        # tensors are held to 1e-2 here.
        rel = 1e-2 if (k.startswith("stem.") and not frozen) else 1e-4
        scale = want[k].abs().max().item()
        assert (g - want[k]).abs().max().item() <= rel * scale + 1e-6, k
    stats = from_flax({"batch_stats": numpy_tree(j_stats)})
    for k, v in stats.items():
        np.testing.assert_allclose(port.state_dict()[k].numpy(), v.numpy(),
                                   rtol=BN_TOL, atol=BN_TOL, err_msg=k)
        changed = not np.allclose(v.numpy(), from_flax(
            {"batch_stats": variables["batch_stats"]})[k].numpy())
        assert changed != frozen, k


def test_visformer_train_gradients_match_jax_in_float64(setup):
    """The same comparison in float64 on both sides, batch-statistics BN:
    every parameter's gradient within 1e-9 of its max-abs. This is what shows
    that the two packages compute the same function where their fp32 results
    differ in the stem."""
    x, variables, head_w, labels = setup
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(a, jnp.float64)
        jm = JVisformer(**SMALL_VISFORMER, dtype=jnp.float64)
        (j_loss, _), j_grads = _j_loss(jm, jax.tree_util.tree_map(f64, variables), f64(x),
                                       f64(head_w), jnp.asarray(labels))
        want = from_flax({"params": numpy_tree(j_grads)})
        j_loss = float(j_loss)
    port = load_flax(TVisformer(**SMALL_VISFORMER, device="cpu", dtype=torch.float64),
                     variables).double().train()
    float_ = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double  # BN's fp32 statistics, in float64 for this test
    try:
        pooled = port(torch.from_numpy(x).double())[1]
    finally:
        torch.Tensor.float = float_
    loss = F.cross_entropy(pooled @ torch.from_numpy(head_w).double(), torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - j_loss) < 1e-12
    for k, p in port.named_parameters():
        assert want[k].dtype == torch.float64
        scale = want[k].abs().max().item()
        assert (p.grad - want[k]).abs().max().item() <= 1e-9 * scale + 1e-15, k


def test_train_mode_with_rates_is_stochastic_and_seeded(setup):
    x, variables, _, _ = setup
    port = load_flax(TVisformer(**SMALL_VISFORMER, device="cpu", drop_path_rate=0.5,
                                drop_rate=0.1, attn_drop_rate=0.1), variables).train()
    xt = torch.from_numpy(x)
    with torch.no_grad(), tc.frozen_bn():
        with tc.draws_from(torch.Generator().manual_seed(5)):
            a = port(xt)[1]
        with tc.draws_from(torch.Generator().manual_seed(5)):
            b = port(xt)[1]
        with tc.draws_from(torch.Generator().manual_seed(6)):
            c = port(xt)[1]
        d = port.eval()(xt)[1]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.allclose(a, d)
    assert torch.isfinite(a).all()
