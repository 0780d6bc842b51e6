"""Port parity, OT math: ``ops.emd`` and the Sinkhorn kernel's wrapper
against the JAX package's ``ops.emd`` and ``sinkhorn_pallas`` (interpret
mode), same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.kernels.sinkhorn import sinkhorn_pallas as j_sinkhorn_pallas
from fewshot_vit_tpu.ops import emd as jemd
from fewshot_vit_tpu.ops.metric import normal_confidence_interval as j_normal_ci
from fewshot_vit_tpu_torch.kernels import sinkhorn as tks
from fewshot_vit_tpu_torch.ops import emd as temd
from fewshot_vit_tpu_torch.ops.metric import normal_confidence_interval as t_normal_ci

torch.set_num_threads(1)


def _problem(b, n1, n2, seed):
    """Cost in [0, 1] and JAX-normalized marginals, as numpy float32."""
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 1, (b, n1, n2)).astype(np.float32)
    w1 = np.asarray(jemd.normalize_weights(jnp.asarray(rng.uniform(-0.2, 1, (b, n1)), jnp.float32)))
    w2 = np.asarray(jemd.normalize_weights(jnp.asarray(rng.uniform(-0.2, 1, (b, n2)), jnp.float32)))
    return cost, w1, w2


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_normalize_weights_and_emd_distance_match_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 7, 13)).astype(np.float32)  # negatives hit the relu
    want = np.asarray(jemd.normalize_weights(jnp.asarray(w)))
    np.testing.assert_allclose(temd.normalize_weights(torch.from_numpy(w)).numpy(), want,
                               rtol=0, atol=1e-6)
    sim = rng.uniform(-1, 1, (4, 5, 13, 13)).astype(np.float32)
    flow = rng.uniform(0, 1, (4, 5, 13, 13)).astype(np.float32)
    want = np.asarray(jemd.emd_distance(jnp.asarray(sim), jnp.asarray(flow), 12.5))
    got = temd.emd_distance(*_t(sim, flow), 12.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,n1,n2,iters", [(12, 25, 25, 50), (5, 9, 9, 100), (4, 13, 9, 100)])
def test_sinkhorn_matches_jax(b, n1, n2, iters):
    cost, w1, w2 = _problem(b, n1, n2, seed=n1 + n2)
    want = np.asarray(jemd.sinkhorn(*map(jnp.asarray, (cost, w1, w2)), iters=iters))
    got = temd.sinkhorn(*_t(cost, w1, w2), iters=iters)
    assert got.shape == (b, n1, n2) and got.dtype == torch.float32
    # fp32 exp/log/sum in another order than XLA:CPU, over `iters` rounds
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,n,iters,block_b", [(12, 25, 50, 8), (5, 9, 30, 4)])
def test_sinkhorn_pallas_cpu_matches_jax_interpret(b, n, iters, block_b):
    """The CPU path of the kernel's wrapper against the Pallas kernel run in
    interpret mode, at the JAX kernel test's shapes and tolerance."""
    cost, w1, w2 = _problem(b, n, n, seed=b)
    want = np.asarray(j_sinkhorn_pallas(*map(jnp.asarray, (cost, w1, w2)), iters=iters,
                                        block_b=block_b, interpret=True))
    before = tks.sinkhorn_pallas.launches
    got = tks.sinkhorn_pallas(*_t(cost, w1, w2), iters=iters)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    assert tks.sinkhorn_pallas.launches == before  # the plain version is no launch
    out = torch.full((b, n, n), float("nan"))
    assert tks.sinkhorn_pallas(*_t(cost, w1, w2), iters=iters, out=out) is out
    torch.testing.assert_close(out, got, rtol=0, atol=0)


def test_differentiable_flag():
    cost, w1, w2 = _t(*_problem(2, 9, 9, seed=4))
    cost.requires_grad_(True)
    flow = temd.sinkhorn(cost, w1, w2, iters=10, differentiable=True)
    (g,) = torch.autograd.grad(flow.sum() + (flow * cost).sum(), cost)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    detached = temd.sinkhorn(cost, w1, w2, iters=10)
    assert not detached.requires_grad and detached.grad_fn is None
    assert not tks.sinkhorn_pallas(cost, w1, w2, iters=10).requires_grad
    torch.testing.assert_close(detached, flow.detach(), rtol=0, atol=0)


def test_marginals_after_convergence():
    """The column update is the last one, so column sums equal w2; rows
    converge to w1 for these well-conditioned problems."""
    cost, w1, w2 = _t(*_problem(6, 13, 13, seed=9))
    flow = tks.sinkhorn_pallas(cost, w1, w2)
    torch.testing.assert_close(flow.sum(-2), w2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(flow.sum(-1), w1, rtol=1e-2, atol=1e-2)


def test_normal_confidence_interval_matches_jax():
    accs = np.random.default_rng(2).uniform(0.2, 1.0, 37).astype(np.float32)
    np.testing.assert_allclose(t_normal_ci(accs), j_normal_ci(accs), rtol=1e-12)
    m, h = t_normal_ci(accs)
    assert h == pytest.approx(1.96 * np.std(accs.astype(np.float64)) / np.sqrt(37))
