"""Plain PyTorch reference of one SUN training step (Dong et al., "Self-
Promoted Supervision for Few-Shot Transformer", ECCV 2022): a frozen teacher
labels every patch of the weak view, the student learns from the strong
view, and AdamW (decoupled weight decay, torch's defaults) updates it.

  * teacher: the encoder on running statistics, its dense map through the
    GLOBAL classifier -> patch logits (B, T, C);
  * soft labels over C + 1 classes: ``off`` = smoothing / C everywhere,
    ``on`` = 1 - smoothing + off at the k largest classes; the ``bg`` least
    salient patches (lowest largest logit) get ``on`` at the background
    class C instead (ties of either ranking go to the lower index);
  * student: batch-statistics BN, stochastic depth drawn per sample from a
    generator keyed by (seed, epoch, step); loss = CE(global logits, labels)
    + weight * mean over patches of the soft cross-entropy of the local
    classifier's (B, T, C + 1) logits.

``key_generator`` is a frozen copy of the measured program's rule for the
generator of a step's stochastic-depth draws (``core/rng.py``); the
reference draws its masks from it, in block order, as the program does.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .visformer import Encoder


def key_generator(device, *key: int) -> torch.Generator:
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed >> 1)


def drop_path(gen: torch.Generator):
    """Per-sample stochastic depth from ``gen``: kept rows scaled by 1 / keep."""

    def fn(x: torch.Tensor, rate: float) -> torch.Tensor:
        keep = 1.0 - rate
        mask = torch.rand((x.shape[0], 1, 1, 1), generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    return fn


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return x @ p[f"{name}.linear.weight"].t() + p[f"{name}.linear.bias"]


def sub(p: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def soft_labels(logits: torch.Tensor, smoothing: float, k: int, bg: int) -> torch.Tensor:
    b, t, c = logits.shape
    off = smoothing / c
    on = 1.0 - smoothing + off
    keep = torch.sort(logits.amax(-1), dim=-1, descending=True, stable=True).indices[:, :t - bg]
    fg = torch.zeros(b, t, dtype=torch.bool, device=logits.device)
    fg[torch.arange(b, device=logits.device)[:, None], keep] = True
    top = torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]
    label = torch.full((b, t, c + 1), off, dtype=logits.dtype, device=logits.device)
    label.scatter_(2, top, on)
    bg_label = torch.full((c + 1,), off, dtype=logits.dtype, device=logits.device)
    bg_label[c] = on
    return torch.where(fg[..., None], label, bg_label)


def teacher_logits(teacher: Dict[str, torch.Tensor], cfg: dict, weak: torch.Tensor) -> torch.Tensor:
    """The frozen teacher's patch logits (B, T, C) through its global classifier."""
    with torch.no_grad():
        dense, _ = Encoder(sub(teacher, "encoder."), cfg)(weak)
        b, h, w, c = dense.shape
        return linear(dense.reshape(b, h * w, c), teacher, "classifier")


def teacher_labels(teacher: Dict[str, torch.Tensor], cfg: dict, weak: torch.Tensor,
                   sun: dict) -> torch.Tensor:
    return soft_labels(teacher_logits(teacher, cfg, weak), sun["smoothing"], sun["soft_k"],
                       sun["bg_tokens"])


def student_loss(student: Dict[str, torch.Tensor], cfg: dict, strong: torch.Tensor,
                 labels: torch.Tensor, soft: torch.Tensor, key: Tuple[int, ...],
                 sun: dict) -> torch.Tensor:
    gen = key_generator(strong.device, *key)
    enc = Encoder(sub(student, "encoder."), cfg, bn="batch", drop_path=drop_path(gen))
    dense, pooled = enc(strong)
    b, h, w, c = dense.shape
    cls = F.cross_entropy(linear(pooled, student, "classifier"), labels)
    token = linear(dense.reshape(b, h * w, c), student, "classifier_local")
    token_loss = torch.sum(-soft * F.log_softmax(token, dim=-1), dim=-1).mean()
    return cls + sun["token_weight"] * token_loss


def cosine_lr(epoch: int, base: float, epochs: int, warmup: int, warmup_lr: float,
              lr_min: float = 0.0) -> float:
    """timm CosineLRScheduler stepped at every epoch's end: 1-based epoch E
    runs at get_lr(E - 2), the first at the warmup rate."""
    if epoch <= 1:
        return warmup_lr if warmup > 0 else base
    t = epoch - 2
    if t < warmup:
        return warmup_lr + t * (base - warmup_lr) / warmup
    if t >= epochs:
        return lr_min
    return lr_min + 0.5 * (base - lr_min) * (1.0 + math.cos(math.pi * t / epochs))


class AdamW:
    """torch.optim.AdamW with its defaults (betas 0.9, 0.999; eps 1e-8)."""

    def __init__(self, lr: float, weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        for k, g in grads.items():
            p = params[k]
            m = self.m.setdefault(k, torch.zeros_like(p))
            v = self.v.setdefault(k, torch.zeros_like(p))
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v / (1.0 - b2 ** self.t)).sqrt() + self.eps
            p.sub_(self.lr * (m / (1.0 - b1 ** self.t)) / denom)
