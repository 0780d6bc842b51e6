"""Optimizers and learning-rate schedules (counterpart:
``fewshot_vit_tpu/train/optim.py``).

The reference's recipes, on ``torch.optim``:

  * teacher pretraining: AdamW, lr scaled by batch/512, timm
    ``CosineLRScheduler``;
  * SUN-M meta-tuning: SGD(momentum 0.9) with torch ``MultiStepLR``, or with
    timm ``MultiStepLRScheduler`` and warmup;
  * SUN-D meta-tuning: Nesterov SGD with StepLR (``train/meta_tune_emd.py``);
  * weight decay on EVERY parameter (biases, norm scales and the
    meta-baseline temperature too); ``mask_decay=True`` opts into the timm
    rule (rank >= 2 only).

Every reference scheduler holds the rate constant within an epoch, so a
schedule here is an ``EpochSchedule``: a plain list of rates indexed by the
0-based epoch, whose last value persists. The trainer sets it on the
optimizer's param groups at the start of each epoch
(``ScheduledOptimizer.set_epoch``). timm's schedulers are stepped
``step(epoch - 1)`` at the END of 1-based epoch ``epoch``, so epoch E >= 2
runs at ``get_lr(E - 2)`` and epoch 1 at the construction-time rate
(``warmup_lr`` when warmup is on, else the base rate).
"""

from __future__ import annotations

import bisect
import math
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch


class EpochSchedule(list):
    """Per-epoch learning rates; ``at(e)`` is the rate of 0-based epoch ``e``,
    the last value persisting past the table."""

    def at(self, epoch: int) -> float:
        return self[min(int(epoch), len(self) - 1)]


def _timm_epoch_sequence(get_lr, epochs: int, warmup_epochs: int,
                         warmup_lr: float, base_lr: float, extra: int = 2) -> List[float]:
    first = warmup_lr if warmup_epochs > 0 else base_lr
    return [first] + [get_lr(e - 1) for e in range(1, epochs + extra)]


def timm_cosine_schedule(base_lr: float, epochs: int, warmup_epochs: int = 0,
                         warmup_lr: float = 1e-6, lr_min: float = 0.0) -> EpochSchedule:
    """timm ``CosineLRScheduler(t_initial=epochs, warmup_t, warmup_lr_init,
    cycle_limit=1)``: warmup counts inside ``t_initial`` (the cosine never
    reaches ``base_lr``), and past the single cycle the rate is ``lr_min``."""

    def get_lr(t: int) -> float:
        if t < warmup_epochs:
            return warmup_lr + t * (base_lr - warmup_lr) / warmup_epochs
        if t // epochs >= 1:
            return lr_min
        return lr_min + 0.5 * (base_lr - lr_min) * (
            1.0 + math.cos(math.pi * (t % epochs) / epochs))

    return EpochSchedule(_timm_epoch_sequence(get_lr, epochs, warmup_epochs, warmup_lr, base_lr))


def timm_multistep_schedule(base_lr: float, epochs: int, milestones: Sequence[int],
                            gamma: float = 0.5, warmup_epochs: int = 3,
                            warmup_lr: float = 1e-5) -> EpochSchedule:
    """timm ``MultiStepLRScheduler(decay_t=milestones, decay_rate=gamma,
    warmup_t, warmup_lr_init)``: it decays at ``bisect_right(milestones,
    t + 1)``, which cancels the ``step(epoch - 1)`` lag, so the decayed rate
    is first used in epoch ``milestone + 1``, as with torch ``MultiStepLR``."""
    ms = sorted(int(m) for m in milestones)

    def get_lr(t: int) -> float:
        if t < warmup_epochs:
            return warmup_lr + t * (base_lr - warmup_lr) / warmup_epochs
        return base_lr * gamma ** bisect.bisect_right(ms, t + 1)

    return EpochSchedule(_timm_epoch_sequence(get_lr, epochs, warmup_epochs, warmup_lr, base_lr))


def multistep_schedule(base_lr: float, milestones: Sequence[int],
                       gamma: float = 0.1) -> EpochSchedule:
    """torch ``MultiStepLR`` stepped once at each epoch end: 1-based epoch E
    runs at ``base_lr * gamma ** bisect_right(milestones, E - 1)``. The
    product is taken in float32, factor by factor, as the JAX package's
    piecewise-constant schedule takes it."""
    ms = sorted(int(m) for m in milestones)
    lrs = []
    for e in range((ms[-1] if ms else 0) + 1):
        scale = np.prod(np.full(bisect.bisect_right(ms, e), gamma, np.float32), dtype=np.float32)
        lrs.append(float(np.float32(base_lr) * scale))
    return EpochSchedule(lrs)


def zero_nan_tensor(g: torch.Tensor) -> torch.Tensor:
    """Zero the WHOLE tensor when any element is NaN (the reference's
    ``detect_grad_nan`` calls ``param.grad.zero_()``), not element by element."""
    return torch.where(torch.isnan(g).any(), torch.zeros_like(g), g)


def zero_nan_grads(params: Iterable[torch.Tensor]) -> None:
    """``zero_nan_tensor`` on every ``.grad``, in place, without a host sync;
    a column-parallel parameter's slices are zeroed together when any of
    them holds a NaN, as the whole tensor is."""
    for p in params:
        if p.grad is None:
            continue
        tp = getattr(p, "tp", None)
        if tp is None:
            p.grad = zero_nan_tensor(p.grad)
        else:
            from ..parallel.mesh import reduce_sum_

            bad = reduce_sum_(torch.isnan(p.grad).any().reshape(1), tp.group)
            p.grad = torch.where(bad, torch.zeros_like(p.grad), p.grad)


def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> None:
    """Scale every ``.grad`` by ``max_norm / max(norm, max_norm)``, the global
    L2 norm over all of them (optax ``clip_by_global_norm``), taken over the
    whole of every column-parallel parameter (``parallel.mesh``)."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if any(getattr(p, "tp", None) is not None for p in params):
        from ..parallel.mesh import global_sq_norm

        norm = torch.sqrt(global_sq_norm(grads, params))
    else:
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                     for g in grads]))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale)


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer with what the recipes put around it, in the
    order the JAX package's optax chain applies them: NaN zeroing
    (``zero_nan``), global-norm clipping (``grad_clip``) on the raw gradients,
    then the optimizer's own weight decay and update. ``schedule`` is an
    ``EpochSchedule`` or None (constant rate)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Optional[EpochSchedule] = None,
                 grad_clip: Optional[float] = None, zero_nan: bool = False):
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.zero_nan = zero_nan

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    def set_epoch(self, epoch: int) -> float:
        """Set the rate of 0-based ``epoch`` on every param group; returns it."""
        if self.schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule.at(epoch)
        return self.lr

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.zero_nan:
            zero_nan_grads(self.params)
        if self.grad_clip:
            clip_by_global_norm_(self.params, float(self.grad_clip))
        self.optimizer.step()

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state)


def make_optimizer(params: Iterable[torch.nn.Parameter], name: str = "sgd", lr: float = 1e-3,
                   weight_decay: float = 0.0, schedule: Optional[EpochSchedule] = None,
                   grad_clip: Optional[float] = None,
                   mask_decay: bool = False) -> ScheduledOptimizer:
    """sgd (momentum 0.9) | adam (decay coupled into the gradient) | adamw
    (decoupled), with an optional schedule and global-norm clipping. Weight
    decay hits every parameter unless ``mask_decay`` (then rank >= 2 only)."""
    params = list(params)
    if mask_decay:
        groups = [{"params": [p for p in params if p.dim() >= 2], "weight_decay": weight_decay},
                  {"params": [p for p in params if p.dim() < 2], "weight_decay": 0.0}]
    else:
        groups = [{"params": params, "weight_decay": weight_decay}]
    if name == "sgd":
        opt = torch.optim.SGD(groups, lr=lr, momentum=0.9)
    elif name == "adam":
        opt = torch.optim.Adam(groups, lr=lr)
    elif name == "adamw":
        opt = torch.optim.AdamW(groups, lr=lr)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    out = ScheduledOptimizer(opt, schedule, grad_clip)
    out.set_epoch(0)
    return out
