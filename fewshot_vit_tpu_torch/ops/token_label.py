"""SUN self-promoted supervision: teacher patch logits -> soft token labels
(counterpart: ``fewshot_vit_tpu/ops/token_label.py``).

  * off = smoothing / C, on = 1 - smoothing + off (C = number of base
    classes; off uses C, not C + 1, as the reference does);
  * each patch's label over C + 1 classes is ``off`` everywhere and ``on`` at
    the teacher's top-k classes;
  * the ``bg_tokens`` patches with the lowest max-logit (least salient) get
    ``on`` at the background class C instead.

The JAX package's fix of the reference's background label is kept: the
reference fills the background map with ``c`` taken from
``logits_max.size(1)``, which is 1 after its ``max(dim=1, keepdim=True)``,
so it labels background tokens as REAL CLASS 1; here, as in the JAX package,
they are labelled class C, the extra class that the (C + 1)-wide labels and
``classifier_local`` exist for.

Both index sets (the kept tokens, the top-k classes) are chosen by a stable
descending sort, so ties go to the lower index, as ``jax.lax.top_k`` breaks
them: the labels are the JAX package's bit for bit, ties included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties to the
    lower index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def generate_soft_label(logits: torch.Tensor, smoothing: float = 0.1, k: int = 5,
                        bg_tokens: int = 10) -> torch.Tensor:
    """Teacher patch logits (B, T, C) -> soft labels (B, T, C + 1)."""
    b, t, c = logits.shape
    if not 0 <= bg_tokens < t:
        raise ValueError(f"bg_tokens={bg_tokens} must be in [0, {t}) for {t} patch tokens")
    if not 0 < k <= c:
        raise ValueError(f"k={k} must be in (0, {c}] for {c} classes")
    off = smoothing / c
    on = 1.0 - smoothing + off

    # foreground: the (T - bg) most salient patches keep class labels
    saliency = torch.amax(logits, dim=-1)  # (B, T)
    keep = _top_indices(saliency, t - bg_tokens)
    fg_mask = torch.zeros_like(saliency).scatter_(1, keep, 1.0)  # (B, T)

    # top-k class one-hot per patch, over C + 1 classes (background never in top-k)
    top = _top_indices(logits, k)  # (B, T, k)
    topk_hot = torch.zeros((b, t, c + 1), dtype=logits.dtype,
                           device=logits.device).scatter_(2, top, 1.0)

    fg_label = off + topk_hot * (on - off)
    bg_label = torch.full((c + 1,), off, dtype=logits.dtype, device=logits.device)
    bg_label[c] = on
    m = fg_mask[..., None]
    return fg_label * m + bg_label * (1.0 - m)


def soft_target_cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over tokens of sum(-target * log_softmax(logits)); (..., C) each."""
    return torch.sum(-target * F.log_softmax(logits, dim=-1), dim=-1).mean()
