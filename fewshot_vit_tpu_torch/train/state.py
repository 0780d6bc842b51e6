"""Train state (counterpart: ``fewshot_vit_tpu/train/state.py``): the module,
its optimizer, the step count and an optional EMA shadow of the parameters."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..parallel.mesh import all_gather, gathered_state_dict, map_optimizer_state, sliced_state_dict
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
    ``state_dict()`` / ``load_state_dict()`` carry all of it, for resume.
    A module with column-parallel layers (``parallel.param_shardings``)
    holds slices; every view here is in the full layout (gathered, a
    collective every rank calls), and a loaded state is cut to the slices."""

    def __init__(self, module: nn.Module, optimizer: ScheduledOptimizer, ema: bool = False):
        self.module = module
        self.optimizer = optimizer
        self.step = 0
        self.ema_params: Optional[Dict[str, torch.Tensor]] = (
            {n: p.detach().clone() for n, p in module.named_parameters()} if ema else None)

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        """The module's state dict: parameters and BN running statistics."""
        return gathered_state_dict(self.module)

    @property
    def ema_variables(self) -> Dict[str, torch.Tensor]:
        """The module's state dict with the EMA shadow in place of the
        parameters (the BN statistics are the live ones, as in the JAX
        package)."""
        return gathered_state_dict(self.module, {**self.module.state_dict(), **self.ema_params})

    def ema_update(self, decay: float = 0.9997) -> None:
        ema_update(self.ema_params, self.module, decay)

    def state_dict(self) -> dict:
        gather = lambda t, tp: all_gather(t, tp.group, tp.size, dim=0)
        out = {"step": self.step, "model": self.variables,
               "optimizer": map_optimizer_state(self.optimizer.optimizer,
                                                self.optimizer.state_dict(), gather)}
        if self.ema_params is not None:
            out["ema_params"] = gathered_state_dict(self.module, self.ema_params)
        return out

    def load_state_dict(self, state: dict) -> None:
        def cut(t, tp):
            w = tp.full_out // tp.size
            return t[tp.index * w:(tp.index + 1) * w] if t.shape[0] == tp.full_out else t

        self.module.load_state_dict(sliced_state_dict(self.module, state["model"]))
        self.optimizer.load_state_dict(
            map_optimizer_state(self.optimizer.optimizer, state["optimizer"], cut))
        self.step = int(state["step"])
        if self.ema_params is not None and "ema_params" in state:
            for name, t in sliced_state_dict(self.module, state["ema_params"]).items():
                self.ema_params[name].copy_(t)


def resume_train_state(resume_dir: str, state: TrainState,
                       map_location="cpu") -> Tuple[TrainState, dict, Optional[str]]:
    """Restore a full-train-state resume checkpoint into ``state``, tolerating
    an ``ema_decay`` toggled between the save and the restart: a shadow the
    checkpoint lacks is re-seeded from the loaded parameters, one the state
    does not want is dropped. Returns ``(state, meta, note)``, ``note`` a log
    line or None."""
    from ..checkpoint.io import load_variables

    saved, meta = load_variables(resume_dir, map_location=map_location)
    state.load_state_dict(saved)
    note = None
    if state.ema_params is not None and "ema_params" not in saved:
        state.ema_params = {n: p.detach().clone() for n, p in state.module.named_parameters()}
        note = ("resume: checkpoint carries no EMA shadow (ema_decay was "
                "enabled after the last save) — re-seeded it from the loaded params")
    elif state.ema_params is None and "ema_params" in saved:
        note = "resume: dropping the checkpoint's EMA shadow (ema_decay now disabled)"
    return state, meta, note
