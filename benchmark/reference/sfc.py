"""Plain PyTorch SFC, DeepEMD's structured fully connected layer for k-shot
episodes (Zhang et al., "DeepEMD", CVPR 2020, as SUN-D runs it at eval):
the shot-mean prototypes are its weights, refined by SGD on the
cross-entropy of the EMD logits of the support set against them; the
queries are then matched to the refined prototypes.

``refine`` in fp32. Each step walks the support set in the order the
step's permutation gives (the program's draws, injected), in mini-batches
of ``batch_size``; the last mini-batch wraps around to the order's start
with the wrapped items masked out of the loss. A mini-batch's loss per
episode is the masked sum of its items' cross-entropy over the number of
items kept; its gradient with respect to the prototypes reaches them
through the similarities alone, the flows being the solver's output and
not differentiated (as DeepEMD's eval computes them); the update is SGD
with momentum 0.9 and dampening 0.9 in ``torch.optim.SGD``'s form (the
first buffer is the raw gradient, then buf = 0.9 buf + 0.1 g).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .heads import emd_flow


def similarity(proto: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """proto (E, way, N, C), query (E, Q, N, C) -> (E, Q, way, N, N): the
    cosine of the centred nodes, as ``heads.emd_flow`` computes it."""
    centre = lambda t: F.normalize(t - t.mean(dim=-1, keepdim=True), dim=-1)
    return torch.einsum("eqnc,ewmc->eqwnm", centre(query), centre(proto))


def refine(proto: torch.Tensor, support: torch.Tensor, perms: torch.Tensor, way: int,
           lr: float, batch_size: int, temperature: float, reg: float, iters: int,
           momentum: float = 0.9, dampening: float = 0.9) -> torch.Tensor:
    """proto (E, way, N, C) shot means; support (E, way * shot, N, C) with
    item t * way + w of class w; perms (E, steps, way * shot) -> the refined
    prototypes (E, way, N, C), fp32."""
    e, n_support = support.shape[:2]
    p = proto.detach().float()
    support = support.detach().float()
    labels = torch.arange(n_support, device=p.device) % way
    eidx = torch.arange(e, device=p.device)[:, None]
    buf = None
    for s in range(perms.shape[1]):
        order = torch.cat([perms[:, s], perms[:, s, :batch_size]], dim=1)
        for first in range(0, n_support, batch_size):
            idx = order[:, first:first + batch_size]  # (E, bs)
            mask = ((torch.arange(batch_size, device=p.device) + first) < n_support).float()
            batch = support[eidx, idx]
            with torch.no_grad():
                _, flow = emd_flow(p, batch, reg, iters, torch.float32)
            with torch.enable_grad():
                q = p.requires_grad_(True)
                logits = (similarity(q, batch) * flow).sum(dim=(-1, -2)) * (
                    temperature / flow.shape[-1])
                ce = F.cross_entropy(logits.transpose(1, 2), labels[idx], reduction="none")
                loss = (ce * mask).sum(dim=-1) / mask.sum().clamp(min=1.0)
                (g,) = torch.autograd.grad(loss.sum(), q)
            buf = g if buf is None else momentum * buf + (1.0 - dampening) * g
            p = p.detach() - lr * buf
    return p
