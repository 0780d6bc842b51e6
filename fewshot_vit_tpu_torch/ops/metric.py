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


def compute_acc(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean top-1 accuracy over every leading axis, a 0-d float32 tensor."""
    return (torch.argmax(logits, dim=-1) == label).to(torch.float32).mean()


def per_episode_acc(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Accuracy per episode: logits (E, Q, N), label (E, Q) -> (E,) float32.

    ``argmax`` returns the first maximum, as ``jnp.argmax`` does. The mean is
    the count times the fp32 reciprocal of Q, which is how XLA lowers
    ``jnp.mean`` (``Tensor.mean`` divides, and differs by one ulp for some
    counts), so the accuracies are bit-identical to the JAX package's."""
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == label).to(torch.float32).sum(dim=-1)
    return correct * torch.tensor(1.0 / label.shape[-1], dtype=torch.float32)


def compute_logits_kshot(feat: torch.Tensor, proto: torch.Tensor, temp=1.0) -> torch.Tensor:
    """Per-shot cosine logits (reference ``compute_logits_kshot``):
    feat (B, M, K, C), proto (B, N, K, C) -> (B, N, K), summed over M."""
    return torch.einsum("bmkc,bnkc->bnk", l2_normalize(proto), l2_normalize(feat)) * temp


def compute_logits_local_kshot(feat: torch.Tensor, proto: torch.Tensor, temp=1.0) -> torch.Tensor:
    """Mean local cosine similarity over the last-but-one axis (reference
    ``compute_logits_local_kshot``): (..., T, C) pairs -> (...)."""
    cos = torch.sum(l2_normalize(feat) * l2_normalize(proto), dim=-1)
    return cos.mean(dim=-1) * temp


def compute_acc_kshots(logits: torch.Tensor, label: torch.Tensor, shot: int = 5) -> torch.Tensor:
    """Max-over-shots accuracy (reference ``compute_acc_kshots``): logits
    (B, way*shot) -> the class of each row's best shot, against ``label``."""
    per_class = logits.reshape(logits.shape[0], -1, shot).amax(dim=-1)
    correct = (torch.argmax(per_class, dim=1) == label).to(torch.float32).sum()
    # times the fp32 reciprocal, as XLA lowers jnp.mean (see per_episode_acc)
    return correct * torch.tensor(1.0 / label.shape[0], dtype=torch.float32)


def softmax_kl_loss(input_logits: torch.Tensor, target_logits: torch.Tensor,
                    matching: torch.Tensor) -> torch.Tensor:
    """Masked softmax-KL (reference ``softmax_kl_loss``): KL(target || input)
    over axis 1, weighted by ``matching``, summed and divided by the mask's
    sum. The target is detached: gradients reach ``input_logits`` only."""
    logp = torch.log_softmax(input_logits, dim=1)
    q = torch.softmax(target_logits, dim=1).detach()
    kl = q * (torch.log(q.clamp_min(1e-12)) - logp)
    return torch.sum(kl * matching) / torch.sum(matching)


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


def roc_auc(scores, labels) -> float:
    """Binary ROC-AUC, rank-based with tied scores given their average rank
    (sklearn's ``roc_auc_score``; the reference ``--sauc`` mode). scores
    (M,), higher = more positive; labels (M,) in {0, 1}. Float64, host side;
    NaN when one class is absent."""
    s = np.asarray(scores, dtype=np.float64).reshape(-1)
    y = np.asarray(labels).reshape(-1)
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(s) + 1)
    sorted_s = s[order]
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i: j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    n_pos = int(np.sum(y == 1))
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((np.sum(ranks[y == 1]) - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))
