"""Train state (counterpart: ``fewshot_vit_tpu/train/state.py``): the module,
its optimizer, the step count and an optional EMA shadow of the parameters."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .optim import ScheduledOptimizer


def ema_update(ema_params: Dict[str, torch.Tensor], module: nn.Module,
               decay: float = 0.9997) -> None:
    """``ema = decay * ema + (1 - decay) * param``, in place, per parameter."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            ema_params[name].mul_(decay).add_(p.detach(), alpha=1.0 - decay)


class TrainState:
    """``module`` + ``optimizer`` + ``step`` (+ ``ema_params`` when
    ``ema=True``: detached copies of the parameters, by name).
    ``state_dict()`` / ``load_state_dict()`` carry all of it, for resume."""

    def __init__(self, module: nn.Module, optimizer: ScheduledOptimizer, ema: bool = False):
        self.module = module
        self.optimizer = optimizer
        self.step = 0
        self.ema_params: Optional[Dict[str, torch.Tensor]] = (
            {n: p.detach().clone() for n, p in module.named_parameters()} if ema else None)

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        """The module's state dict: parameters and BN running statistics."""
        return self.module.state_dict()

    def ema_update(self, decay: float = 0.9997) -> None:
        ema_update(self.ema_params, self.module, decay)

    def state_dict(self) -> dict:
        out = {"step": self.step, "model": self.module.state_dict(),
               "optimizer": self.optimizer.state_dict()}
        if self.ema_params is not None:
            out["ema_params"] = self.ema_params
        return out

    def load_state_dict(self, state: dict) -> None:
        self.module.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if self.ema_params is not None:
            for name, t in state["ema_params"].items():
                self.ema_params[name].copy_(t)
