"""Optimal-transport math for DeepEMD matching (counterpart:
``fewshot_vit_tpu/ops/emd.py``).

``sinkhorn`` is the port of the JAX package's ``lax.scan`` version: batched
entropic OT in the log domain over a fixed number of iterations, on torch
ops, on any device. It is what ``solver: sinkhorn_detached`` and the SFC
inner loop run; ``solver: sinkhorn_pallas`` runs the CUDA kernel
(``kernels/sinkhorn.py``) instead. Weights follow the reference: each side is
rescaled to sum to its node count.
"""

from __future__ import annotations

import torch


def normalize_weights(w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """relu + eps, then rescale to sum to the node count."""
    w = torch.relu(w) + eps
    n = w.shape[-1]
    return w * n / torch.sum(w, dim=-1, keepdim=True)


def _sinkhorn(cost, w1, w2, reg, iters):
    log_w1 = torch.log(w1)
    log_w2 = torch.log(w2)
    log_k = -cost / reg  # (..., N1, N2)
    f = torch.zeros_like(log_w1)
    g = torch.zeros_like(log_w2)
    for _ in range(iters):
        # row scaling then column scaling, in the log domain
        f = log_w1 - torch.logsumexp(log_k + g[..., None, :], dim=-1)
        g = log_w2 - torch.logsumexp(log_k + f[..., None], dim=-2)
    return torch.exp(log_k + f[..., None] + g[..., None, :])


def sinkhorn(
    cost: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    reg: float = 0.05,
    iters: int = 100,
    differentiable: bool = False,
) -> torch.Tensor:
    """Entropic-OT flow for batched problems.

    cost (..., N1, N2), w1 (..., N1) row marginals, w2 (..., N2) column
    marginals (already normalized by ``normalize_weights``) -> flow
    (..., N1, N2). With ``differentiable=False`` the iterations run under
    ``torch.no_grad()`` and the flow is detached (the JAX stop-gradient);
    with ``True`` they stay in the autograd graph.
    """
    if differentiable:
        return _sinkhorn(cost, w1, w2, reg, iters)
    with torch.no_grad():
        return _sinkhorn(cost, w1, w2, reg, iters)


def emd_distance(sim: torch.Tensor, flow: torch.Tensor, temperature: float) -> torch.Tensor:
    """logits = sum(similarity * flow) * temperature / num_node."""
    num_node = sim.shape[-1]
    return torch.sum(sim * flow, dim=(-1, -2)) * (temperature / num_node)
