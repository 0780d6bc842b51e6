"""Checkpoint save/load and the save policy (counterpart:
``fewshot_vit_tpu/checkpoint/io.py``).

The port's own format: a checkpoint is a directory holding ``arrays.pt``
(``torch.save`` of a state dict, or of a ``TrainState.state_dict()`` for
resume) beside a ``meta.json`` with the keys the JAX package writes (model
name, encoder, epoch, val_acc). It is not the JAX package's orbax layout:
the two packages do not read each other's checkpoints. Both read the
reference's ``.pth`` files (``checkpoint/reference.py``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

ARRAYS = "arrays.pt"


def save_variables(path: str, variables: Any, meta: Optional[Dict] = None) -> None:
    """Save a state dict + JSON meta at ``path`` (a directory).

    Atomic: everything is written to a ``.tmp`` sibling first and swapped
    into place once arrays and meta are on disk, so a crash mid-save never
    destroys the previous checkpoint (the per-epoch ``resume`` directory is
    the crash-recovery path). In a process group only rank 0 writes."""
    from ..parallel.mesh import is_main_process

    if not is_main_process():
        return
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    if os.path.exists(old):
        if not os.path.exists(path):
            os.rename(old, path)  # a save crashed between its two renames
        else:
            shutil.rmtree(old)
    os.makedirs(tmp)
    torch.save(variables, os.path.join(tmp, ARRAYS))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta or {}, f, indent=2, default=str)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)


def is_pth(path: str) -> bool:
    """A reference checkpoint file, not a directory of this package."""
    return str(path).endswith(".pth")


def _resolve(path: str) -> Optional[str]:
    path = os.path.abspath(path)
    for p in (path, path + ".old"):  # ``.old``: only survivor of an interrupted swap
        if os.path.isfile(os.path.join(p, ARRAYS)):
            return p
    return None


def has_checkpoint(path: str) -> bool:
    """True iff ``load_variables(path)`` would find a checkpoint directory,
    including the case where only ``path + '.old'`` survived an interrupted
    swap."""
    return _resolve(path) is not None


def load_variables(path: str, map_location: Any = "cpu") -> Tuple[Any, Dict]:
    """Load ``(variables, meta)`` from a directory ``save_variables`` wrote,
    or ``(state dict, {model, model_args})`` from a reference ``.pth`` file
    (``reference.load_torch_state_dict``: CPU tensors, keys as the file has
    them, ``module.`` stripped)."""
    if is_pth(path):
        from .reference import load_torch_state_dict

        return load_torch_state_dict(path)
    found = _resolve(path)
    if found is None:
        raise FileNotFoundError(f"no checkpoint at {path!r} (expected a directory "
                                f"holding {ARRAYS})")
    variables = torch.load(os.path.join(found, ARRAYS), map_location=map_location,
                           weights_only=True)
    meta_path = os.path.join(found, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return variables, meta


def load_module_state(path: str, map_location: Any = "cpu") -> Tuple[Dict, Dict]:
    """``load_variables`` for loading a module: a ``resume`` directory's
    train state gives its ``model`` entry."""
    variables, meta = load_variables(path, map_location)
    if isinstance(variables.get("model"), dict):
        variables = variables["model"]
    return variables, meta


def load_model(path: str, device: Any = "cuda", **overrides: Any):
    """Rebuild a registered head from a checkpoint directory's ``meta.json``
    (``model``, and the ``encoder`` and ``n_classes`` the trainers record)
    and return it on ``device`` with its state dict loaded (a ``resume``
    directory's ``model``). ``overrides`` go to the constructor (e.g.
    ``encoder_args``, ``dtype``), as the reference's ``models.load(sv)``
    rebuilds from the saved name and arguments."""
    from ..core.registry import models
    from ..heads import classifier, deepemd, meta_baseline, token_label  # noqa: F401

    variables, meta = load_module_state(path)
    name = meta.get("model")
    if name is None:
        raise ValueError(f"checkpoint at {path!r} has no 'model' in its meta")
    kwargs: Dict[str, Any] = {}
    if meta.get("encoder"):
        kwargs["encoder"] = meta["encoder"]
    if meta.get("n_classes") is not None:
        kwargs["classifier_args"] = {"n_classes": int(meta["n_classes"])}
    kwargs.update(overrides)
    model = models.make(name, device=device, **kwargs)
    model.load_state_dict(variables, strict=True)
    return model


class CheckpointPolicy:
    """``epoch-last`` every epoch, ``epoch-N`` every ``save_epoch`` epochs,
    ``max-va`` on the best validation accuracy so far."""

    def __init__(self, save_dir: str, save_epoch: Optional[int] = None):
        self.save_dir = save_dir
        self.save_epoch = save_epoch
        # seed from an existing max-va (or its crash-window copy) so a resumed
        # run cannot overwrite the best checkpoint with a worse epoch
        self.best_va = -float("inf")
        for name in ("max-va", "max-va.old"):
            meta_path = os.path.join(save_dir, name, "meta.json")
            if os.path.exists(meta_path):
                try:
                    with open(meta_path) as f:
                        prev = json.load(f).get("val_acc")
                    if prev is not None:
                        self.best_va = max(self.best_va, float(prev))
                except (ValueError, OSError):
                    pass

    def on_epoch(self, epoch: int, variables: Any, meta: Dict,
                 va: Optional[float] = None) -> None:
        meta = dict(meta, epoch=epoch, val_acc=va)
        save_variables(os.path.join(self.save_dir, "epoch-last"), variables, meta)
        if self.save_epoch and epoch % self.save_epoch == 0:
            save_variables(os.path.join(self.save_dir, f"epoch-{epoch}"), variables, meta)
        if va is not None and va > self.best_va:
            self.best_va = va
            save_variables(os.path.join(self.save_dir, "max-va"), variables, meta)
