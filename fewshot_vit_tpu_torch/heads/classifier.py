"""Whole-classification heads for teacher pretraining and the SUN global
classifier (counterpart: ``fewshot_vit_tpu/heads/classifier.py``).

Module names (``encoder``, ``classifier.linear``, ``classifier.proto``) are
the reference torch model's attribute paths, so the state-dict keys are
those of its checkpoints. A head computes in the encoder's dtype with fp32
parameters, as flax's ``dtype=`` does.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..core.registry import models
from .. import models as _models  # noqa: F401  (registers the encoders)
from ..models.common import trunc_normal_
from ..ops.metric import compute_logits


class LinearClassifier(nn.Module):
    """A plain linear head, ``linear`` an ``nn.Linear`` initialized as flax's
    ``Dense``: truncated-normal LeCun kernel, zero bias."""

    def __init__(self, in_dim: int, n_classes: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = nn.Linear(in_dim, n_classes)
        self.dtype = dtype
        with torch.no_grad():
            # variance_scaling(1, fan_in, truncated_normal): std of the untruncated normal
            trunc_normal_(self.linear.weight, math.sqrt(1.0 / in_dim) / 0.87962566103423978,
                          generator)
            self.linear.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype),
                        self.linear.bias.to(self.dtype))


class NNClassifier(nn.Module):
    """Learnable-prototype metric head: ``proto`` (n_classes, in_dim) and, for
    the cosine metric without a fixed ``temp``, a learnable fp32 ``temp``
    (init 10)."""

    def __init__(self, in_dim: int, n_classes: int, metric: str = "cos",
                 temp: Optional[float] = None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proto = nn.Parameter(torch.empty(n_classes, in_dim))
        # flax kaiming_uniform over a (n_classes, in_dim) shape: fan_in = n_classes
        bound = math.sqrt(6.0 / n_classes)
        with torch.no_grad():
            self.proto.uniform_(-bound, bound, generator=generator)
        self.metric = metric
        self.dtype = dtype
        if temp is None and metric == "cos":
            self.temp = nn.Parameter(torch.tensor(10.0))
        else:
            self.temp = temp if temp is not None else 1.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return compute_logits(x, self.proto.to(x.dtype), self.metric, self.temp)


class Classifier(nn.Module):
    """Encoder + global classifier on the pooled feature: (B, H, W, 3) ->
    (B, n_classes) logits in the compute dtype."""

    # whole-classification signature, not the episodic (x_shot, x_query) one
    standard_episodic = False

    def __init__(self, encoder: nn.Module, classifier: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.classifier = classifier

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, pooled = self.encoder(x)
        return self.classifier(pooled)


@models.register("classifier")
def make_classifier(
    encoder: str,
    encoder_args: Optional[dict] = None,
    classifier: str = "linear-classifier",
    classifier_args: Optional[dict] = None,
    dtype: torch.dtype = torch.float32,
    device: Any = "cuda",
    seed: int = 0,
) -> Classifier:
    device = resolve_device(device)
    enc = models.make(encoder, dtype=dtype, device=device, seed=seed, **(encoder_args or {}))
    cargs = dict(classifier_args or {})
    n_classes = cargs.pop("n_classes")
    gen = torch.Generator().manual_seed(seed + 1)
    if classifier == "linear-classifier":
        head: nn.Module = LinearClassifier(enc.out_dim, n_classes, dtype, gen, **cargs)
    elif classifier == "nn-classifier":
        in_dim = cargs.pop("in_dim", enc.out_dim)
        head = NNClassifier(in_dim, n_classes, dtype=dtype, generator=gen, **cargs)
    else:
        raise ValueError(f"unknown classifier {classifier!r}")
    return Classifier(enc, head).to(device).eval()
