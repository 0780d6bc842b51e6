"""DeepEMD head, SUN-D (counterpart: ``fewshot_vit_tpu/heads/deepemd.py``).

  * cross-reference weight vectors: node weights = relu(<node, other side's
    global mean>) + 1e-3;
  * center-normalized node features and a cosine (or l2) similarity map
    between every (query node, prototype node) pair;
  * EMD flows over cost = 1 - similarity, logits = sum(sim * flow) *
    temperature / num_node. The flows come from ``ops.emd.sinkhorn`` (torch
    ops), with ``solver: sinkhorn_pallas`` from the CUDA kernel
    (``kernels/sinkhorn.py``), or with ``solver: exact`` from the C++
    transportation simplex on the host (``exact_flows``);
  * SFC: k-shot prototypes refined by SGD(momentum .9, dampening .9) steps
    against the support set at eval time;
  * nodes: per-patch pooled features for 5-D patch batches (grid), or the
    dense feature map (fcn), optionally after a feature pyramid.

Everything is batched over episodes: (E, way, N, C) prototypes against
(E, Q, N, C) queries in one pass, as the JAX package vmaps them.
"""

from __future__ import annotations

import inspect
import time
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import trace
from ..core.device import resolve_device
from ..core.registry import models
from ..core.rng import DEFAULT_SEED
from .. import models as _models  # noqa: F401  (registers the encoders)
from ..ops.emd import emd_distance, normalize_weights, sinkhorn, sinkhorn_scan
from ..ops.metric import l2_normalize

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


def exact_flows(cost: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Exact transportation-simplex flows from the C++ solver
    (``native/emd_solver.cpp``), one problem per (query, prototype) pair:
    the semantics of the reference's eval path (cv2.EMD with detached
    flows). Every exact solver reaches the same optimal objective, hence the
    same ``(sim * flow).sum()`` logits, even where the optimal flow itself is
    not unique.

    cost (..., N1, N2), w1 (..., N1), w2 (..., N2). The inputs are detached
    and cast to fp32, go to the host in float64 through the simplex, and the
    flows come back as fp32 on the cost's device: constants of the autograd
    graph, as JAX's ``pure_callback`` makes them. The host seconds spent
    here add up in ``exact_flows.host_seconds``."""
    t0 = time.perf_counter()
    from ..native.emd import emd_exact

    n1, n2 = cost.shape[-2:]
    host = lambda t, *shape: t.detach().float().cpu().numpy().astype(np.float64).reshape(shape)
    flows, _ = emd_exact(host(cost, -1, n1, n2), host(w1, -1, n1), host(w2, -1, n2))
    out = torch.from_numpy(flows.astype(np.float32).reshape(cost.shape)).to(cost.device)
    exact_flows.host_seconds += time.perf_counter() - t0
    return out


exact_flows.host_seconds = 0.0


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
    through the CUDA Sinkhorn kernel; ``'exact'`` through the C++ simplex on
    the host (``exact_flows``); ``'xla'`` runs ``ops.emd.sinkhorn``. With
    ``differentiable=True`` the torch-op Sinkhorn runs unless the impl is
    ``'exact'``, as in JAX. Otherwise the flows are constants: gradients
    reach the inputs only through ``sim``."""
    proto = proto.float()
    query = query.float()
    w_query = weight_vector(query, proto)                 # (..., Q, way, N)
    w_proto = weight_vector(proto, query).transpose(-2, -3)  # (..., Q, way, N)

    sim = similarity_map(center_normalize(proto, norm), center_normalize(query, norm),
                         metric)                          # (..., Q, way, Nq, Np)
    w1 = normalize_weights(w_query)
    w2 = normalize_weights(w_proto)
    with trace.span("emd.solver"):
        if solver_impl == "exact":
            flow = exact_flows(1.0 - sim, w1, w2)
        elif solver_impl == "pallas" and not differentiable:
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


# emd_logits's matching settings and their defaults, the keywords
# sfc_refine_explicit takes: its own signature, so the two cannot drift apart
_EMD_DEFAULTS = {name: p.default for name, p in inspect.signature(emd_logits).parameters.items()
                 if name in ("temperature", "metric", "norm", "solver_reg", "solver_iters")}


def sfc_grad(proto: torch.Tensor, batch: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor, temperature: float = 12.5, norm: str = "center",
             solver_reg: float = 0.05, solver_iters: int = 100) -> torch.Tensor:
    """Gradient, in closed form, of SFC's per-episode loss
    ``sum(CE(emd_logits(proto, batch), labels) * mask) / max(sum(mask), 1)``
    with respect to ``proto`` (E, way, N, C); batch (E, bs, N, C), labels
    (E, bs), mask (bs,). What autograd gives ``sfc_refine``, written out so
    that a traced program holds no autograd:

      * the flows are constants (stop-gradient Sinkhorn, here its ``scan``),
        and so are the marginals they alone consume: the gradient reaches
        ``proto`` only through the cosine similarity;
      * d loss / d logits = (softmax - onehot) * mask / max(sum(mask), 1);
      * logits[q, w] = T / Np * sum_nm flow[q, w, n, m] <q_hat[q, n], p_hat[w, m]>,
        so d / d p_hat[w, m] = T / Np * sum_qn g[q, w] flow[q, w, n, m] q_hat[q, n];
      * through ``l2_normalize`` (p_hat = x / max(|x|, eps)): (d - p_hat
        <p_hat, d>) / |x|, or d / eps where the clamp holds; through
        ``center_normalize``: d - mean_c(d).
    """
    eps = 1e-12  # l2_normalize's
    w1 = normalize_weights(weight_vector(batch, proto))
    w2 = normalize_weights(weight_vector(proto, batch).transpose(-2, -3))
    cp, cq = center_normalize(proto, norm), center_normalize(batch, norm)
    p_hat, q_hat = l2_normalize(cp), l2_normalize(cq)
    sim = torch.einsum("...qnc,...wmc->...qwnm", q_hat, p_hat)   # as similarity_map
    flow = sinkhorn_scan(1.0 - sim, w1, w2, reg=solver_reg, iters=solver_iters)
    logits = emd_distance(sim, flow, temperature)                # (E, bs, way)
    way = proto.shape[-3]
    onehot = F.one_hot(labels, way).to(logits.dtype)
    g = (torch.softmax(logits, dim=-1) - onehot) * (mask / torch.clamp(mask.sum(), min=1.0))[:, None]
    d_hat = torch.einsum("eqw,eqwnm,eqnc->ewmc", g, flow, q_hat) * (temperature / sim.shape[-1])
    nrm = torch.linalg.vector_norm(cp, dim=-1, keepdim=True)
    d = torch.where(nrm > eps, (d_hat - p_hat * (p_hat * d_hat).sum(-1, keepdim=True)) / nrm,
                    d_hat / eps)
    return d - d.mean(dim=-1, keepdim=True) if norm == "center" else d


def sfc_refine_explicit(
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
    """``sfc_refine`` for a traced program: the same perms, mini-batches,
    masks and momentum rule, but each step's gradient from ``sfc_grad`` (no
    autograd), the steps as one ``scan`` over the perms and each inner
    Sinkhorn as a ``scan`` over its iterations, so an exported 100-step SFC
    holds one step body, not 100 x n_batches x ``solver_iters`` copies.
    ``emd_kw`` takes ``emd_logits``'s cosine-metric settings (temperature,
    norm, solver_reg, solver_iters); the inner flows are the stop-gradient
    torch-op Sinkhorn, as in ``sfc_refine``."""
    from torch._higher_order_ops.scan import scan

    kw = {**_EMD_DEFAULTS, **emd_kw}
    if set(kw) != set(_EMD_DEFAULTS) or kw.pop("metric") != "cosine":
        raise ValueError(f"sfc_refine_explicit takes {sorted(_EMD_DEFAULTS)} with the cosine "
                         f"metric, got {sorted(emd_kw)} ({emd_kw.get('metric', 'cosine')})")
    e = proto.shape[0]
    n_support = way * shot
    n_batches = -(-n_support // batch_size)
    dev = proto.device
    p0 = proto.detach().float()
    support = support.detach().float()
    labels = torch.arange(way, device=dev).repeat(shot)
    if perms is None:
        perms = sfc_perms(episode_ids, steps, n_support, seed)
    perms = perms.to(dev)
    eidx = torch.arange(e, device=dev)[:, None]

    def step(carry, perm):  # perm (E, n_support)
        p, buf, t = carry
        ext = torch.cat([perm, perm[:, :batch_size]], dim=1)
        for b in range(n_batches):
            idx = ext[:, b * batch_size:(b + 1) * batch_size]  # (E, bs)
            mask = ((torch.arange(batch_size, device=dev) + b * batch_size)
                    < n_support).float()
            g = sfc_grad(p, support[eidx, idx], labels[idx], mask, **kw)
            buf = torch.where(t == 0, g, momentum * buf + (1.0 - dampening) * g)
            p = p - lr * buf
            t = t + 1
        return (p, buf, t), t.clone()  # the per-step output may not alias the carry

    init = (p0, torch.zeros_like(p0), torch.zeros((), dtype=torch.int64, device=dev))
    (p, _, _), _ = scan(step, init, perms.transpose(0, 1))
    return p


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
    """Encoder + DeepEMD matching, or (``n_classes``) the pretrain classifier
    ``fc`` over the pooled feature.

    In training mode the encoder's dropout and drop-path are live; the SUN-D
    trainer wraps ``encode_nodes`` in ``models.common.frozen_bn()``. With
    ``solver: sinkhorn_unrolled`` the flows stay in the autograd graph; with
    ``sinkhorn_detached``, ``sinkhorn_pallas`` and ``exact`` they are
    constants."""

    # driven by its own loops (train/meta_tune_emd.py, eval/run_emd.py), not
    # the standard episodic meta-tune contract (train/meta_tune.py)
    standard_episodic = False

    def __init__(self, encoder: nn.Module, n_classes: Optional[int] = None,
                 temperature: float = 12.5, metric: str = "cosine", norm: str = "center",
                 solver_reg: float = 0.05, solver_iters: int = 100,
                 solver: str = "sinkhorn_detached",
                 feature_pyramid: Optional[Sequence[int]] = None, seed: int = 0):
        super().__init__()
        self.encoder = encoder
        self.n_classes = n_classes
        if n_classes is not None:
            self.fc = nn.Linear(encoder.out_dim, n_classes)
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():  # flax Dense defaults: lecun-normal kernel, zero bias
                self.fc.weight.normal_(0.0, encoder.out_dim ** -0.5, generator=gen)
                self.fc.bias.zero_()
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
        """x (B, H, W, 3) -> class logits (B, n_classes), in the compute dtype."""
        _, pooled = self.encoder(x)
        return F.linear(pooled, self.fc.weight.to(pooled.dtype), self.fc.bias.to(pooled.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The pretrain path when ``n_classes`` is set, else ``encode_nodes``."""
        return self.pre_train(x) if self.n_classes is not None else self.encode_nodes(x)

    def meta(self, proto_nodes: torch.Tensor, query_nodes: torch.Tensor) -> torch.Tensor:
        """proto (..., way, N, C), query (..., Q, N, C) -> (..., Q, way)."""
        with trace.span("emd.head"):
            return emd_logits(
                proto_nodes, query_nodes, temperature=self.temperature, metric=self.metric,
                norm=self.norm, solver_reg=self.solver_reg, solver_iters=self.solver_iters,
                differentiable=self.solver == "sinkhorn_unrolled",
                solver_impl={"sinkhorn_pallas": "pallas", "exact": "exact"}.get(self.solver,
                                                                                "xla"),
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
                   solver, feature_pyramid, seed).to(device).eval()
