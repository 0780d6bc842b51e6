"""Metric math: prototype logits, accuracy, confidence intervals
(counterpart: ``fewshot_vit_tpu/ops/metric.py``)."""

from __future__ import annotations

import numpy as np
import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Torch ``F.normalize`` semantics: x / max(||x||, eps)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def compute_logits(
    feat: torch.Tensor,
    proto: torch.Tensor,
    metric: str = "dot",
    temp=1.0,
) -> torch.Tensor:
    """Query-vs-prototype logits: feat (..., Q, C), proto (..., N, C) -> (..., Q, N).

    metric: 'dot' | 'cos' | 'sqr' (negative squared distance).
    """
    if metric == "cos":
        feat = l2_normalize(feat)
        proto = l2_normalize(proto)
        metric = "dot"
    if metric == "dot":
        logits = torch.einsum("...qc,...nc->...qn", feat, proto)
    elif metric == "sqr":
        diff = feat[..., :, None, :] - proto[..., None, :, :]
        logits = -torch.sum(diff * diff, dim=-1)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return logits * temp


def per_episode_acc(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Accuracy per episode: logits (E, Q, N), label (E, Q) -> (E,) float32.

    ``argmax`` returns the first maximum, as ``jnp.argmax`` does. The mean is
    the count times the fp32 reciprocal of Q, which is how XLA lowers
    ``jnp.mean`` (``Tensor.mean`` divides, and differs by one ulp for some
    counts), so the accuracies are bit-identical to the JAX package's."""
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == label).to(torch.float32).sum(dim=-1)
    return correct * torch.tensor(1.0 / label.shape[-1], dtype=torch.float32)


def mean_confidence_interval(accs, confidence: float = 0.95):
    """(mean, halfwidth) of a Student-t confidence interval over episode accs
    (scipy ``t.ppf``, as ``test_phase/test_few_shot.py:20-25``). Host side."""
    from scipy import stats

    a = np.asarray(accs, dtype=np.float64).reshape(-1)
    n = a.shape[0]
    m = float(np.mean(a))
    if n < 2:
        return m, 0.0
    se = float(stats.sem(a))
    h = se * float(stats.t.ppf((1 + confidence) / 2.0, n - 1))
    return m, h


def normal_confidence_interval(accs):
    """(mean, halfwidth) with the SUN-D formula ``1.96 * std / sqrt(n)``,
    population std (ddof 0), as the SUN-D eval reports it; not the Student-t
    interval of ``mean_confidence_interval``. Host side."""
    a = np.asarray(accs, dtype=np.float64).reshape(-1)
    m = float(np.mean(a))
    pm = 1.96 * float(np.std(a)) / np.sqrt(a.shape[0])
    return m, pm
