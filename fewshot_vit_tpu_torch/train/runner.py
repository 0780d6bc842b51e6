"""Shared plumbing of the phase runners: config -> dataset / dtype /
optimizer / encoder checkpoint (counterpart:
``fewshot_vit_tpu/train/runner.py``). Each phase's ``main`` lives in its own
module (``meta_tune.py``, ``meta_tune_emd.py``) and calls into here.
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable, Optional, Tuple

import torch
from torch import nn

from ..checkpoint.io import load_variables
from ..core import rng as rng_mod
from ..core.config import Config, load_config
from ..core.registry import datasets
from ..data.datasets import ArrayDataset
from .optim import (
    ScheduledOptimizer,
    make_optimizer,
    multistep_schedule,
    timm_cosine_schedule,
    timm_multistep_schedule,
)

_AUXILIARIES = "comes with the auxiliaries slice (ROADMAP.md, item f of the order list)"


def parse_args(description: str, argv=None) -> Tuple[Config, argparse.Namespace]:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True)
    p.add_argument("--name", default=None)
    p.add_argument("--tag", default=None)
    p.add_argument("--seed", type=int, default=rng_mod.DEFAULT_SEED)
    p.add_argument("--save-root", default="./save")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    return load_config(args.config), args


def check_single_device(cfg: Config) -> None:
    """Refuse, by name, the keys of the JAX configs that are not ported:
    every trainer's ``main`` calls this before it builds anything."""
    for key in ("distributed", "mesh"):
        if cfg.get(key):
            raise NotImplementedError(f"'{key}:' (multi-device training) {_AUXILIARIES}")
    if cfg.get("visualize_datasets"):
        raise NotImplementedError(f"'visualize_datasets: true' (sample-grid PNGs) {_AUXILIARIES}")


def save_dir_for(cfg: Config, args: argparse.Namespace, default_name: str) -> str:
    name = args.name or default_name
    if args.tag:
        name += f"_{args.tag}"
    path = os.path.join(args.save_root, name)
    os.makedirs(path, exist_ok=True)
    return path


_DTYPE_NAMES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}


def model_dtype(cfg: Config, key: str = "model_args.dtype", default: str = "float32"):
    """Compute dtype of the model from ``model_args.dtype`` (or ``key``).
    ``bfloat16``: parameters and optimizer state stay fp32, convs and
    matmuls run in bf16, BN statistics and every loss in fp32."""
    name = str(cfg.get(key, default)).lower()
    try:
        return _DTYPE_NAMES[name]
    except KeyError:
        raise ValueError(f"{key}={name!r}: expected one of {sorted(_DTYPE_NAMES)}") from None


def build_dataset(cfg: Config, key: str) -> Optional[ArrayDataset]:
    name = cfg.get(key)
    if name is None:
        return None
    return datasets.make(name, **dict(cfg.get(f"{key}_args", {}) or {}))


def build_optimizer(cfg: Config, params: Iterable[nn.Parameter],
                    batch_size: int = 0) -> ScheduledOptimizer:
    """Optimizer + per-epoch schedule from a phase config (``optimizer``,
    ``optimizer_args``, ``max_epoch``), every branch of the JAX package's."""
    name = cfg.get("optimizer", "sgd")
    oargs = dict(cfg.get("optimizer_args", {}) or {})
    if name == "sam":
        # SAM is a two-pass step around a base optimizer, which is what is
        # built here; the SAM step itself (optimizer_args.sam_rho) belongs to
        # the pretrain loop and comes with the pretrain slice
        name = oargs.get("base", "sgd")
    lr = float(oargs.get("lr", 1e-3))
    if oargs.get("scale_lr_by_batch") and batch_size:
        lr = lr * batch_size / 512.0
    wd = float(oargs.get("weight_decay", 0.0) or 0.0)
    epochs = int(cfg.get("max_epoch", 100))
    warmup = int(oargs.get("warmup_epochs", 0))
    sched_name = oargs.get("schedule", "cosine" if name == "adamw" else "multistep")
    if sched_name == "cosine":
        sched = timm_cosine_schedule(
            lr, epochs, warmup, warmup_lr=float(oargs.get("warmup_lr", 1e-6)),
            lr_min=float(oargs.get("min_lr", 0.0)))
    elif sched_name == "multistep" and oargs.get("milestones"):
        gamma = float(oargs.get("gamma", 0.1))
        if warmup > 0:
            sched = timm_multistep_schedule(
                lr, epochs, oargs["milestones"], gamma=gamma, warmup_epochs=warmup,
                warmup_lr=float(oargs.get("warmup_lr", 1e-5)))
        else:
            sched = multistep_schedule(lr, oargs["milestones"], gamma=gamma)
    else:
        sched = None
    return make_optimizer(params, name, lr=lr, weight_decay=wd, schedule=sched,
                          grad_clip=oargs.get("grad_clip"),
                          mask_decay=bool(oargs.get("mask_decay", False)))


def load_encoder_from_checkpoint(path: str, encoder: nn.Module) -> nn.Module:
    """Load ``encoder`` from a checkpoint directory of any head-wrapped model
    (keys under ``encoder.``; head parameters and ``temp`` are discarded) or
    of a bare encoder. A reference ``.pth`` raises ``NotImplementedError``."""
    saved, _ = load_variables(path)
    if "model" in saved and isinstance(saved["model"], dict):  # a resume directory
        saved = saved["model"]
    enc = {k[len("encoder."):]: v for k, v in saved.items() if k.startswith("encoder.")}
    encoder.load_state_dict(enc or saved, strict=True)
    return encoder
