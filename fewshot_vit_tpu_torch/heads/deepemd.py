"""DeepEMD head, SUN-D (counterpart: ``fewshot_vit_tpu/heads/deepemd.py``).

  * cross-reference weight vectors: node weights = relu(<node, other side's
    global mean>) + 1e-3;
  * center-normalized node features and a cosine (or l2) similarity map
    between every (query node, prototype node) pair;
  * EMD flows over cost = 1 - similarity, logits = sum(sim * flow) *
    temperature / num_node. The flows come from ``ops.emd.sinkhorn`` (torch
    ops) or, with ``solver: sinkhorn_pallas``, from the CUDA kernel
    (``kernels/sinkhorn.py``);
  * SFC: k-shot prototypes refined by SGD(momentum .9, dampening .9) steps
    against the support set at eval time;
  * nodes: per-patch pooled features for 5-D patch batches (grid), or the
    dense feature map (fcn), optionally after a feature pyramid.

Everything is batched over episodes: (E, way, N, C) prototypes against
(E, Q, N, C) queries in one pass, as the JAX package vmaps them.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..core.registry import models
from ..core.rng import DEFAULT_SEED
from ..models import visformer as _visformer  # noqa: F401  (registers the encoders)
from ..ops.emd import emd_distance, normalize_weights, sinkhorn
from ..ops.metric import l2_normalize

_TRAINING_SLICE = "comes with the training slice (ROADMAP.md section 1, slice 3)"


# --- node-feature math (node-major: (..., N, C)) --------------------------------


def weight_vector(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, N, C), b (..., K, N, C) -> (..., M, K, N):
    w[m, k, n] = relu(<a[m, n], mean_n(b[k])>) + 1e-3."""
    b_mean = b.mean(dim=-2)
    w = torch.einsum("...mnc,...kc->...mkn", a, b_mean)
    return torch.relu(w) + 1e-3


def _pool_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """Row-stochastic (n_out, n_in) matrix of torch's adaptive_avg_pool1d
    bins: bin i averages input [floor(i*n/s), ceil((i+1)*n/s))."""
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        a = (i * n_in) // n_out
        b = -((-(i + 1) * n_in) // n_out)
        m[i, a:b] = 1.0 / (b - a)
    return torch.from_numpy(m)


def pyramid_nodes(dense: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """Feature-pyramid node set: (B, H, W, C) -> (B, sum(s*s) + H*W, C),
    adaptive-average-pooled levels first, the raw map last."""
    b, h, w, c = dense.shape
    levels = []
    for s in sizes:
        s = int(s)
        ph = _pool_matrix(h, s).to(dense.device, dense.dtype)
        pw = _pool_matrix(w, s).to(dense.device, dense.dtype)
        lv = torch.einsum("ih,bhwc,jw->bijc", ph, dense, pw)
        levels.append(lv.reshape(b, s * s, c))
    levels.append(dense.reshape(b, h * w, c))
    return torch.cat(levels, dim=1)


def center_normalize(x: torch.Tensor, norm: str = "center") -> torch.Tensor:
    """Subtract the per-node channel mean."""
    if norm == "center":
        return x - x.mean(dim=-1, keepdim=True)
    return x


def similarity_map(proto: torch.Tensor, query: torch.Tensor,
                   metric: str = "cosine") -> torch.Tensor:
    """proto (..., way, Np, C), query (..., Q, Nq, C) -> (..., Q, way, Nq, Np)."""
    if metric == "cosine":
        return torch.einsum("...qnc,...wmc->...qwnm", l2_normalize(query), l2_normalize(proto))
    if metric == "l2":
        d = query[..., :, None, :, None, :] - proto[..., None, :, None, :, :]
        return 1.0 - torch.sum(d * d, dim=-1)
    raise ValueError(metric)


def emd_logits(
    proto: torch.Tensor,
    query: torch.Tensor,
    temperature: float = 12.5,
    metric: str = "cosine",
    norm: str = "center",
    solver_reg: float = 0.05,
    solver_iters: int = 100,
    differentiable: bool = False,
    solver_impl: str = "xla",
) -> torch.Tensor:
    """DeepEMD matching: proto (..., way, N, C), query (..., Q, N, C) ->
    logits (..., Q, way), always in fp32.

    ``solver_impl='pallas'`` (the JAX package's name) sends the flows
    through the CUDA Sinkhorn kernel; ``'xla'`` runs ``ops.emd.sinkhorn``.
    With ``differentiable=True`` the flows stay in the autograd graph, so the
    torch-op Sinkhorn runs whatever the impl, as in JAX. Otherwise the flows
    are constants: gradients reach the inputs only through ``sim``."""
    if solver_impl == "exact":
        raise NotImplementedError(
            "solver 'exact' (the C++ transportation simplex) is not ported yet: "
            "ROADMAP.md section 1, slice 2")
    proto = proto.float()
    query = query.float()
    w_query = weight_vector(query, proto)                 # (..., Q, way, N)
    w_proto = weight_vector(proto, query).transpose(-2, -3)  # (..., Q, way, N)

    sim = similarity_map(center_normalize(proto, norm), center_normalize(query, norm),
                         metric)                          # (..., Q, way, Nq, Np)
    w1 = normalize_weights(w_query)
    w2 = normalize_weights(w_proto)
    if solver_impl == "pallas" and not differentiable:
        from ..kernels.sinkhorn import sinkhorn_pallas

        cost = 1.0 - sim
        lead = cost.shape[:-2]
        n1, n2 = cost.shape[-2:]
        flow = sinkhorn_pallas(
            cost.reshape(-1, n1, n2), w1.reshape(-1, n1), w2.reshape(-1, n2),
            reg=solver_reg, iters=solver_iters,
        ).reshape(*lead, n1, n2)
    else:
        flow = sinkhorn(1.0 - sim, w1, w2, reg=solver_reg, iters=solver_iters,
                        differentiable=differentiable)
    return emd_distance(sim, flow, temperature)


def sfc_perms(episode_ids: Sequence[int], steps: int, n_support: int,
              seed: int) -> torch.Tensor:
    """(E, steps, n_support) int64 shuffle orders for ``sfc_refine``, from one
    CPU ``torch.Generator`` per GLOBAL episode index, so an episode's
    shuffles do not depend on how episodes are batched."""
    out = torch.empty((len(episode_ids), steps, n_support), dtype=torch.int64)
    for e, ep in enumerate(episode_ids):
        gen = torch.Generator().manual_seed((int(seed) << 32) + int(ep))
        for s in range(steps):
            out[e, s] = torch.randperm(n_support, generator=gen)
    return out


def sfc_refine(
    proto: torch.Tensor,
    support: torch.Tensor,
    way: int,
    shot: int,
    episode_ids: Optional[Sequence[int]] = None,
    steps: int = 100,
    lr: float = 0.1,
    batch_size: int = 4,
    momentum: float = 0.9,
    dampening: float = 0.9,
    perms: Optional[torch.Tensor] = None,
    seed: int = DEFAULT_SEED,
    **emd_kw: Any,
) -> torch.Tensor:
    """SFC prototype refinement, batched over episodes.

    proto (E, way, N, C) = shot-mean init; support (E, way*shot, N, C) in
    the INTERLEAVED item-major order (index t*way + w -> class w), labels
    ``tile(arange(way), shot)``. The shuffle order of each of the ``steps``
    steps comes from ``sfc_perms(episode_ids, steps, way*shot, seed)``, or
    from ``perms`` (E, steps, way*shot) when given. Each step walks the
    shuffled support in mini-batches of ``batch_size``, the last one wrapping
    around to the start of the order with the wrapped items masked out of the
    loss, and takes one SGD step on CE(emd_logits(proto, batch)) per
    mini-batch. The momentum rule is ``torch.optim.SGD``'s: the first buffer
    is the raw gradient, then buf = momentum*buf + (1-dampening)*grad.

    Runs in fp32 with autograd on (callers run the eval under
    ``torch.no_grad()``). ``emd_kw`` goes to the inner ``emd_logits``; the
    JAX eval passes none, so the inner flows come from ``ops.emd.sinkhorn``
    at its defaults. Episodes are independent, so one backward of the summed
    per-episode losses gives each episode its own gradient.
    """
    e = proto.shape[0]
    n_support = way * shot
    n_batches = -(-n_support // batch_size)
    dev = proto.device
    p = proto.detach().float()
    support = support.detach().float()
    labels = torch.arange(way, device=dev).repeat(shot)
    if perms is None:
        perms = sfc_perms(episode_ids, steps, n_support, seed)
    perms = perms.to(dev)
    eidx = torch.arange(e, device=dev)[:, None]
    buf = None
    with torch.enable_grad():
        for s in range(perms.shape[1]):
            ext = torch.cat([perms[:, s], perms[:, s, :batch_size]], dim=1)
            for b in range(n_batches):
                idx = ext[:, b * batch_size:(b + 1) * batch_size]  # (E, bs)
                mask = ((torch.arange(batch_size, device=dev) + b * batch_size)
                        < n_support).float()
                p = p.detach().requires_grad_(True)
                logits = emd_logits(p, support[eidx, idx], **emd_kw)  # (E, bs, way)
                ce = -F.log_softmax(logits, dim=-1).gather(
                    -1, labels[idx][..., None]).squeeze(-1)
                loss = torch.sum(ce * mask, dim=-1) / torch.clamp(mask.sum(), min=1.0)
                (g,) = torch.autograd.grad(loss.sum(), p)
                buf = g if buf is None else momentum * buf + (1.0 - dampening) * g
                p = p.detach() - lr * buf
    return p.detach()


# --- head module ----------------------------------------------------------------


_SOLVER_ALIASES = {
    "opencv": "sinkhorn_detached",
    "sinkhorn": "sinkhorn_detached",
    "qpth": "sinkhorn_unrolled",
}
_SOLVERS = ("sinkhorn_detached", "sinkhorn_unrolled", "sinkhorn_pallas", "exact")


def _canonical_solver(solver: str) -> str:
    """Resolve legacy solver aliases with a warning: 'opencv' and 'sinkhorn'
    name the stop-gradient Sinkhorn, not the exact simplex; 'qpth' names
    Sinkhorn with gradients through the unrolled iterations, not a QP."""
    if solver in _SOLVER_ALIASES:
        new = _SOLVER_ALIASES[solver]
        what = ("differentiable unrolled Sinkhorn, not an interior-point QP"
                if new == "sinkhorn_unrolled"
                else "stop-gradient log-domain Sinkhorn, not the exact simplex")
        warnings.warn(f"solver: '{solver}' is a legacy alias for '{new}' ({what}); "
                      "update your config", stacklevel=3)
        return new
    if solver not in _SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; one of {_SOLVERS} "
                         f"(or legacy alias {tuple(_SOLVER_ALIASES)})")
    return solver


class DeepEMD(nn.Module):
    """Encoder + DeepEMD matching (eval)."""

    def __init__(self, encoder: nn.Module, n_classes: Optional[int] = None,
                 temperature: float = 12.5, metric: str = "cosine", norm: str = "center",
                 solver_reg: float = 0.05, solver_iters: int = 100,
                 solver: str = "sinkhorn_detached",
                 feature_pyramid: Optional[Sequence[int]] = None):
        super().__init__()
        if n_classes is not None:
            raise NotImplementedError(f"DeepEMD pre_train (n_classes) {_TRAINING_SLICE}")
        self.encoder = encoder
        self.temperature = temperature
        self.metric = metric
        self.norm = norm
        self.solver_reg = solver_reg
        self.solver_iters = solver_iters
        self.solver = _canonical_solver(solver)
        self.feature_pyramid = tuple(feature_pyramid) if feature_pyramid else None

    def encode_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) -> dense nodes (B, Hf*Wf [+ pyramid], C);
        x (B, P, H, W, 3) patches -> per-patch pooled nodes (B, P, C)."""
        if x.dim() == 5:
            b, p = x.shape[:2]
            _, pooled = self.encoder(x.reshape(-1, *x.shape[2:]))
            return pooled.reshape(b, p, -1)
        dense, _ = self.encoder(x)
        if self.feature_pyramid:
            return pyramid_nodes(dense, self.feature_pyramid)
        b, h, w, c = dense.shape
        return dense.reshape(b, h * w, c)

    def pre_train(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(f"DeepEMD pre_train {_TRAINING_SLICE}")

    def meta(self, proto_nodes: torch.Tensor, query_nodes: torch.Tensor) -> torch.Tensor:
        """proto (..., way, N, C), query (..., Q, N, C) -> (..., Q, way)."""
        return emd_logits(
            proto_nodes, query_nodes, temperature=self.temperature, metric=self.metric,
            norm=self.norm, solver_reg=self.solver_reg, solver_iters=self.solver_iters,
            differentiable=self.solver == "sinkhorn_unrolled",
            solver_impl={"sinkhorn_pallas": "pallas", "exact": "exact"}.get(self.solver, "xla"),
        )


@models.register("deepemd")
def make_deepemd(
    encoder: str = "visformer_micro_80",
    encoder_args: Optional[dict] = None,
    n_classes: Optional[int] = None,
    temperature: float = 12.5,
    metric: str = "cosine",
    norm: str = "center",
    solver_reg: float = 0.05,
    solver_iters: int = 100,
    solver: str = "sinkhorn_detached",
    feature_pyramid: Optional[Sequence[int]] = None,
    dtype: torch.dtype = torch.float32,
    device: Any = "cuda",
    seed: int = 0,
) -> DeepEMD:
    device = resolve_device(device)
    enc = models.make(encoder, dtype=dtype, device=device, seed=seed, **(encoder_args or {}))
    return DeepEMD(enc, n_classes, temperature, metric, norm, solver_reg, solver_iters,
                   solver, feature_pyramid).to(device).eval()
