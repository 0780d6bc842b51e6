"""Shared plumbing of the phase runners: config -> dataset / dtype /
optimizer / encoder checkpoint / few-shot validation (counterpart:
``fewshot_vit_tpu/train/runner.py``). Each phase's ``main`` lives in its own
module (``pretrain.py``, ``sun.py``, ``meta_tune.py``, ``meta_tune_emd.py``)
and calls into here.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from ..checkpoint.io import is_pth, load_module_state
from ..checkpoint.reference import (
    encoder_key_fn_for,
    load_reference_encoder_checkpoint,
    load_reference_head_checkpoint,
)
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

AUXILIARIES = ("comes with the mesh, the last part of the auxiliaries slice "
               "(ROADMAP.md, item f.4 of the order list)")


def parse_args(description: str, argv=None) -> Tuple[Config, argparse.Namespace]:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True)
    p.add_argument("--name", default=None)
    p.add_argument("--tag", default=None)
    p.add_argument("--seed", type=int, default=rng_mod.DEFAULT_SEED)
    p.add_argument("--save-root", default="./save")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of epoch 2 here")
    args = p.parse_args(argv)
    return load_config(args.config), args


def profile_epoch(args: argparse.Namespace, epoch: int):
    """Context manager: a ``torch.profiler`` trace (CPU and, with a card,
    CUDA activity) around epoch 2 when ``--profile-dir`` is set, written as a
    Chrome trace into that directory on exit; otherwise a ``nullcontext``."""
    import contextlib

    profile_dir = getattr(args, "profile_dir", None)
    if not (profile_dir and epoch == 2):
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    @contextlib.contextmanager
    def traced():
        with profile(activities=activities) as prof:
            yield prof
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, f"epoch{epoch}.trace.json"))

    return traced()


def check_single_device(cfg: Config) -> None:
    """Refuse, by name, the keys of the JAX configs that are not ported:
    every trainer's ``main`` calls this before it builds anything."""
    for key in ("distributed", "mesh"):
        if cfg.get(key):
            raise NotImplementedError(f"'{key}:' (multi-device training) {AUXILIARIES}")


def visualize_datasets(logger, cfg: Config, **named_datasets) -> None:
    """``visualize_datasets: true`` -> one sample-grid PNG per split in the
    run directory, ``visualize_<name>.png`` (the reference flag of the same
    name in every phase config)."""
    if not cfg.get("visualize_datasets"):
        return
    for name, ds in named_datasets.items():
        if ds is not None:
            logger.visualize_dataset(ds, name)


def visualize_augmented(logger, cfg: Config, dataset, aug_fn, mean, std, device,
                        views=("aug",), n_samples: int = 16, draws=None) -> None:
    """``visualize_datasets: true`` -> one grid PNG per augmented view of
    ``n_samples`` training images, as the model sees them, denormalized back
    to uint8: ``visualize_train_aug.png`` (cropaug) or
    ``visualize_train_{strong,weak}.png`` (SUN's dual view). The images are
    the JAX package's draw (``np.random.default_rng(0)``); the augmentation
    runs on ``device`` from a generator seeded 0, or from ``draws`` (the
    pipeline's injected draws) when given."""
    if not cfg.get("visualize_datasets") or aug_fn is None:
        return
    import numpy as np

    from ..data.transforms import denormalize

    rng = np.random.default_rng(0)
    idx = np.sort(rng.choice(len(dataset), min(n_samples, len(dataset)), replace=False))
    images = torch.from_numpy(np.asarray(dataset.images[idx])).to(device)
    gen = torch.Generator(device=images.device).manual_seed(0)
    out = aug_fn(images, gen, draws=draws)
    out = out if isinstance(out, tuple) else (out,)
    for vname, v in zip(views, out):
        u8 = np.clip(denormalize(v, mean, std).cpu().numpy() * 255.0, 0, 255)
        logger.image_grid(f"visualize_train_{vname}", u8.astype(np.uint8))


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
        # SAM is a two-pass step (train/sam.py) around a base optimizer,
        # which is what is built here; the pretrain loop reads sam_rho /
        # adaptive from optimizer_args to select the SAM step
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


def load_encoder_from_checkpoint(path: str, encoder: nn.Module,
                                 encoder_name: Optional[str] = None) -> nn.Module:
    """Load ``encoder`` from a checkpoint of any head-wrapped model, head
    parameters and ``temp`` discarded (the reference's ``load_encoder``): a
    port directory (keys under ``encoder.``, a ``resume`` directory's
    ``model``, or a bare encoder), or a reference ``.pth`` through
    ``checkpoint.reference`` with the key rule of ``encoder_name`` (any
    family of the zoo; default: the port's own names)."""
    if is_pth(path):
        key_fn = encoder_key_fn_for(encoder_name) if encoder_name else None
        return load_reference_encoder_checkpoint(path, encoder, key_fn)
    saved, _ = load_module_state(path)
    enc = {k[len("encoder."):]: v for k, v in saved.items() if k.startswith("encoder.")}
    encoder.load_state_dict(enc or saved, strict=True)
    return encoder


def resolve_checkpoint(cfg: Config, head: nn.Module, encoder_name: str) -> Optional[str]:
    """Apply a config's ``load:`` / ``load_encoder:`` to the freshly built
    ``head``, in place (the JAX package's ``resolve_checkpoint_variables``,
    which both eval CLIs share): ``load:`` a port directory (a whole head
    state dict, or a ``resume`` directory's ``model``) or a reference
    ``.pth`` through the head rule; ``load_encoder:`` a directory or a
    ``.pth``, encoder only. Returns the path loaded, or None when the config
    names no checkpoint.

    A DeepEMD checkpoint may carry the pretrain classifier ``fc`` (a head
    built with ``n_classes``); an episodic head has none and never reads it,
    so a directory's ``fc.*`` entries are dropped then, as the JAX CLIs'
    ``apply`` ignores that subtree."""
    path = cfg.get("load") or cfg.get("load_encoder")
    if not path:
        return None
    if not cfg.get("load"):
        load_encoder_from_checkpoint(path, head.encoder, encoder_name)
        return path
    if is_pth(path):
        load_reference_head_checkpoint(path, head, encoder_key_fn_for(encoder_name))
        return path
    saved, _ = load_module_state(path)
    if not hasattr(head, "fc"):
        saved = {k: v for k, v in saved.items() if not k.startswith("fc.")}
    head.load_state_dict(saved, strict=True)
    return path


def fs_eval(encoder: nn.Module, dataset: ArrayDataset, n_episodes: int = 200, way: int = 5,
            shots=(1, 5), query: int = 15, ep_per_batch: int = 8, seed: int = 0,
            images_dev: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Few-shot validation during training: ``fsa-<shot>`` accuracies of a
    MetaBaseline at the fixed temperature 10 around ``encoder`` itself (in
    eval mode; the JAX package assembles the same view's variables in
    ``fs_head_variables``) on fixed-seed episodes, through
    ``eval.episodic.evaluate`` on the encoder's device."""
    from ..eval.episodic import evaluate
    from ..heads.meta_baseline import MetaBaseline

    head = MetaBaseline(encoder, temp=10.0, temp_learnable=False).eval()
    device = next(encoder.parameters()).device
    out = {}
    for shot in shots:
        acc, _, _ = evaluate(head, dataset, n_episodes=n_episodes, way=way, shot=shot,
                             query=query, ep_per_batch=ep_per_batch, seed=seed,
                             images_dev=images_dev, device=device)
        out[f"fsa-{shot}"] = acc
    return out


def emd_fs_eval(encoder: nn.Module, dataset: ArrayDataset, n_episodes: int = 200,
                way: int = 5, shot: int = 1, query: int = 15, mode: str = "fcn",
                patch_list=(2, 3), num_patch: int = 9, patch_ratio: float = 2.0,
                seed: int = 0, images_dev: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """DeepEMD episodic validation during CE pretraining (``eval_emd: true``):
    a ``DeepEMD`` view of ``encoder`` (default solver) on fixed-seed
    interleaved episodes, one sampler batch per episode, through
    ``eval.emd_eval.evaluate_emd`` (8 episodes a batch: their logits do not
    depend on the grouping); ``emd_acc`` with its Student-t ``emd_ci``, as
    the JAX package reports them."""
    from ..eval.emd_eval import evaluate_emd
    from ..heads.deepemd import DeepEMD
    from ..ops.metric import mean_confidence_interval

    head = DeepEMD(encoder).eval()
    _, _, accs = evaluate_emd(
        head, dataset, way=way, shot=shot, query=query, n_episodes=n_episodes,
        ep_per_batch=8, mode=mode, patch_list=patch_list, patch_ratio=patch_ratio,
        image_size=dataset.images.shape[1], num_patch=num_patch, images_dev=images_dev,
        seed=seed, device=next(encoder.parameters()).device)
    m, h = mean_confidence_interval(accs)
    return {"emd_acc": float(m), "emd_ci": float(h)}
