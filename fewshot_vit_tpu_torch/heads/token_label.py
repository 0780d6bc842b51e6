"""SUN token-label student / teacher head (counterpart: ``TokenLabel`` of
``fewshot_vit_tpu/heads/token_label.py``).

Encoder + global classifier (C classes, on the pooled feature) + local token
classifier (C + 1 classes, background included, on every patch of the dense
map). ``is_teacher=True`` sends the dense map through the GLOBAL classifier:
the teacher labels patches with base classes only. Token logits stay NHWC
(B, H, W, C'). The episodic variants (``token-label-ep*``, ``-v2``) are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.registry import models
from .classifier import LinearClassifier


class TokenLabel(nn.Module):
    # whole-classification signature, not the episodic (x_shot, x_query) one
    standard_episodic = False

    def __init__(self, encoder: nn.Module, n_classes: int, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed + 1)
        self.encoder = encoder
        self.n_classes = n_classes
        self.classifier = LinearClassifier(encoder.out_dim, n_classes, dtype, gen)
        self.classifier_local = LinearClassifier(encoder.out_dim, n_classes + 1, dtype, gen)

    def forward(self, x: torch.Tensor, is_teacher: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (token logits (B, H, W, C or C + 1), global logits (B, C), pooled)."""
        dense, pooled = self.encoder(x)
        y_token = self.classifier(dense) if is_teacher else self.classifier_local(dense)
        return y_token, self.classifier(pooled), pooled


@models.register("token-label")
def make_token_label(
    encoder: str,
    encoder_args: Optional[dict] = None,
    classifier_args: Optional[dict] = None,
    dtype: torch.dtype = torch.float32,
    device: Any = "cuda",
    seed: int = 0,
) -> TokenLabel:
    device = resolve_device(device)
    enc = models.make(encoder, dtype=dtype, device=device, seed=seed, **(encoder_args or {}))
    n_classes = int(dict(classifier_args or {})["n_classes"])
    return TokenLabel(enc, n_classes, dtype, seed).to(device).eval()
