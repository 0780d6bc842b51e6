"""The general route of the Sinkhorn kernel (``csrc/sinkhorn.cu``,
``sinkhorn_kernel``) modelled in plain torch and held against the TPU kernel
in interpret mode: the CUDA kernel cannot run here, so this checks the design
of its arithmetic and of its shared-memory layout, not the kernel
(``test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernel against the
plain version on the card).

The model does what the kernel does, in the kernel's order:

- the base-2 domain: log_k * log2(e) (after the IEEE division -cost / reg),
  log2 of the marginals, potentials in log2 units, flow 2^((log_k + f) + g);
- each log-sum-exp computes x = log_k + pot once, its maximum m, then the
  sum of 2^(x - m) over four partial chains (element j on chain j % 4, each
  chain summed in order of j, the chains added as (s0 + s1) + (s2 + s3)),
  then m + log2(sum): the TPU kernel's max, sum, log order;
- the problem padded as the kernel pads it (log_k -inf beyond N1 and N2,
  potentials 0, the NaN of an all -inf row dropped for 0) leaves every
  potential and the flow as they are.

The model stands exact exp2 / log2 in for ex2.approx / lg2.approx (2 ulp);
the card's distance to the plain version is ``chip_smoke.py`` phase 4's.
Tolerances: PERF.md's kernel rule (1e-4 on the flow) and 1e-3 of the largest
flow entry (``chip_smoke.py`` phase 4 holds the kernel to both). DeepEMD's
marginals sum to the node count, so at N = 196 a flow entry averages 1/N
(5.1e-3) and the largest is about 0.9.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.kernels.sinkhorn import sinkhorn_pallas as j_sinkhorn
from fewshot_vit_tpu_torch.kernels import sinkhorn as tks
from fewshot_vit_tpu_torch.ops.emd import normalize_weights

torch.set_num_threads(1)

LOG2E = torch.tensor(math.log2(math.e), dtype=torch.float32)
SHAPES = ((3, 38, 38), (2, 64, 64), (2, 70, 45), (1, 196, 196))
# csrc/sinkhorn.cu: the padded sizes NP (general_route), the problems a CTA
# holds at each (general_problems; 1 where not listed), the threads a CTA may
# have (kGeneralThreads) and the shared memory it may take on sm_90
SIZES = (40, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 200, 216, tks.MAX_NODES)
PROBLEMS = {40: 4, 48: 2, 56: 4}
MAX_THREADS = 256
SMEM_PER_CTA = 232448


def layout(n1: int, n2: int) -> dict:
    """The general route's launch for (B, n1, n2), as
    ``csrc/sinkhorn.cu::general_launch`` makes it: the padded size ``np``
    (an NP x (NP + 1) tile of log_k per problem; NP lanes a problem, lane t
    owning row t and column t, each log-sum-exp reading NP elements), the
    ``problems`` a CTA holds, ``threads`` and dynamic shared memory a CTA."""
    np_ = next(size for size in SIZES if size >= max(n1, n2))
    problems = PROBLEMS.get(np_, 1)
    return {"np": np_, "problems": problems,
            "threads": problems * np_ if problems > 1 else -(-np_ // 32) * 32,
            "smem_bytes": 4 * problems * (np_ * (np_ + 1) + 2 * np_)}


def _chains(e: torch.Tensor) -> torch.Tensor:
    """sum over the last axis in four chains (element j on chain j % 4, in
    order of j), added as (s0 + s1) + (s2 + s3)."""
    pad = (-e.shape[-1]) % 4
    e = torch.cat([e, torch.zeros(*e.shape[:-1], pad)], -1).unflatten(-1, (-1, 4))
    s = torch.zeros(*e.shape[:-2], 4)
    for q in range(e.shape[-2]):
        s = s + e[..., q, :]
    return (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])


def _lse2(x: torch.Tensor) -> torch.Tensor:
    """log2(sum_j 2^x_j) over the last axis as the kernel computes it."""
    m = x.max(dim=-1).values
    return m + torch.log2(_chains(torch.exp2(x - m[..., None])))


def general_route_model(cost, w1, w2, reg=0.05, iters=100, pad_to=None):
    """(B, N1, N2) fp32 -> the flow, in the general route's arithmetic; with
    ``pad_to`` on a problem padded to that size as the kernel pads it."""
    b, n1, n2 = cost.shape
    lk = (-cost / reg) * LOG2E
    lw1, lw2 = torch.log2(w1), torch.log2(w2)
    if pad_to:
        lk = torch.full((b, pad_to, pad_to), -math.inf).index_put_(
            (torch.arange(b)[:, None, None], torch.arange(n1)[:, None], torch.arange(n2)), lk)
        lw1 = torch.cat([lw1, torch.zeros(b, pad_to - n1)], 1)
        lw2 = torch.cat([lw2, torch.zeros(b, pad_to - n2)], 1)
    rows, cols = torch.arange(lk.shape[1]) < n1, torch.arange(lk.shape[2]) < n2
    f, g = torch.zeros_like(lw1), torch.zeros_like(lw2)
    for _ in range(iters):
        f = torch.where(rows, lw1 - _lse2(lk + g[:, None, :]), 0.0)
        g = torch.where(cols, lw2 - _lse2((lk + f[:, :, None]).transpose(1, 2)), 0.0)
    return torch.exp2((lk + f[:, :, None]) + g[:, None, :])[:, :n1, :n2]


def _problem(b, n1, n2, seed):
    rng = np.random.default_rng(seed)
    cost = torch.from_numpy(rng.uniform(0, 2, (b, n1, n2)).astype(np.float32))
    w1 = normalize_weights(torch.from_numpy(rng.uniform(0, 1, (b, n1)).astype(np.float32)))
    w2 = normalize_weights(torch.from_numpy(rng.uniform(0, 1, (b, n2)).astype(np.float32)))
    return cost, w1, w2


def _jax(cost, w1, w2, iters=100):
    return torch.from_numpy(np.array(j_sinkhorn(
        jnp.asarray(cost.numpy()), jnp.asarray(w1.numpy()), jnp.asarray(w2.numpy()),
        iters=iters, interpret=True)))


@pytest.mark.parametrize("shape", SHAPES)
def test_model_matches_jax_kernel(shape):
    cost, w1, w2 = _problem(*shape, seed=sum(shape))
    want = _jax(cost, w1, w2)
    got = general_route_model(cost, w1, w2)
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= 1e-4 and err <= 1e-3 * scale, (err, scale)
    # the port's CPU path (the plain version) against the same kernel
    plain = tks.sinkhorn_pallas(cost, w1, w2)
    assert (plain - want).abs().max().item() <= 1e-3 * scale


@pytest.mark.parametrize("shape,iters", [((2, 38, 25), 30), ((1, 9, 13), 30), ((2, 5, 3), 0)])
def test_padding_leaves_the_flow_unchanged(shape, iters):
    """-inf rows and columns up to the padded size and potentials 0 there
    (NaN of an all -inf row dropped for 0): the same flow, to the ulp by which
    torch's vectorised and scalar exp2 on the CPU differ."""
    cost, w1, w2 = _problem(*shape, seed=7)
    pad = layout(*shape[1:])["np"]
    got = general_route_model(cost, w1, w2, iters=iters, pad_to=pad)
    want = general_route_model(cost, w1, w2, iters=iters)
    assert pad % 8 == 0 and pad >= max(shape[1:])
    torch.testing.assert_close(got, want, rtol=2e-7, atol=0)


def test_rules_catch_a_wrong_flow():
    """The controls of ``chip_smoke.py`` phase 4 at N = 196: an all-zero flow
    and one with two rows swapped fail the rule relative to the flow's
    largest entry."""
    cost, w1, w2 = _problem(1, 196, 196, seed=3)
    want = tks.sinkhorn_pallas(cost, w1, w2)
    scale = want.abs().max().item()
    for bad in (torch.zeros_like(want), want[:, [1, 0, *range(2, 196)]]):
        err = (bad - want).abs().max().item()
        assert err > 1e-3 * scale, err
    print(f"max flow {scale:.3e}, mean {want.mean().item():.3e}, zero-flow error "
          f"{want.abs().max().item():.3e}, swapped-rows error "
          f"{(want[:, [1, 0, *range(2, 196)]] - want).abs().max().item():.3e}")


@pytest.mark.parametrize("n", [33, 38, 40, 41, 64, 65, 100, 196, 209, tks.MAX_NODES - 1,
                               tks.MAX_NODES])
def test_general_layout_is_conflict_free_and_fits(n):
    """Every warp's 32 lanes read 32 distinct banks in both passes (row pass:
    word g * (NP + 1) + j; column pass: p * NP * (NP + 1) + i * (NP + 1) +
    t), each CTA fits the card's shared memory and its thread limit, and
    the padded size holds the problem."""
    lay = layout(n, n)
    np_, stride = lay["np"], lay["np"] + 1
    assert lay["smem_bytes"] <= SMEM_PER_CTA and lay["threads"] <= MAX_THREADS
    assert n <= np_ and np_ % 8 == 0 and np_ * lay["problems"] <= lay["threads"]
    active = [(tid // np_, tid % np_) for tid in range(lay["threads"])
              if tid // np_ < lay["problems"]]
    for w in range(0, len(active), 32):
        warp = active[w:w + 32]
        for j in (0, 5):
            rows = {(p * np_ * stride + t * stride + j) % 32 for p, t in warp}
            cols = {(p * np_ * stride + j * stride + t) % 32 for p, t in warp}
            assert len(rows) == len(cols) == len(warp), (n, w)


def test_limit_is_what_one_cta_holds():
    assert layout(tks.MAX_NODES, tks.MAX_NODES)["smem_bytes"] <= SMEM_PER_CTA
    bigger = tks.MAX_NODES + 8  # the next size the bank rule allows (NP % 8 == 0)
    assert 4 * (bigger * (bigger + 1) + 2 * bigger) > SMEM_PER_CTA
    with pytest.raises(ValueError, match=f"<= {tks.MAX_NODES} .the general route"):
        tks.sinkhorn_route(tks.MAX_NODES + 1, 9)
