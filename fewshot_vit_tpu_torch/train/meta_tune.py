"""Phase 3a (SUN-M): Meta-Baseline episodic meta-tuning (counterpart:
``fewshot_vit_tpu/train/meta_tune.py``).

Episodic CE over cosine-prototype logits, SGD with a (warmup) multistep
schedule, per-epoch reproducible episode draws, optional ``freeze_bn``,
fixed-seed episodic validation, ``epoch-last`` / ``epoch-N`` / ``max-va``
checkpoints and full-state resume.

Run: ``python -m fewshot_vit_tpu_torch.train.meta_tune --config CONFIG.yaml
[--device cpu]``; the configuration keys are the JAX package's.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..checkpoint.io import CheckpointPolicy, has_checkpoint, load_variables, save_variables
from ..core import rng as rng_mod
from ..core.registry import models
from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
from ..data.sampler import EpisodeSampler
from ..data.staging import epoch_subset, gpu_budget_gb, needs_staging, upload_images
from ..eval.episodic import evaluate, sample_episode_indices
from ..heads import meta_baseline as _heads  # noqa: F401  (registers the heads)
from ..parallel.mesh import param_shardings, use_mesh
from .loop import make_meta_tune_epoch, metrics_mean
from .runner import (
    build_dataset,
    build_optimizer,
    load_encoder_from_checkpoint,
    model_dtype,
    parse_args,
    start_run,
    visualize_datasets,
)
from .state import TrainState


def check_standard_episodic(head, name: str) -> None:
    """Fail at config time when the selected head does not implement the
    standard episodic contract this loop drives: ``head(x_shot (E, way, shot,
    ...), x_query (E, Q, ...)) -> (E, Q, way)`` logits. Heads with loops of
    their own mark themselves with ``standard_episodic = False``."""
    if not getattr(head, "standard_episodic", True):
        raise ValueError(
            f"model {name!r} does not implement the standard episodic "
            "(x_shot, x_query) -> (E, Q, way) logits contract and cannot be "
            "meta-tuned by this loop. It is a research/eval-only or "
            "phase-specific head — see docs/PARITY.md (research ports) and "
            "train/meta_tune_emd.py (DeepEMD).")


def main(cfg, args) -> TrainState:
    mesh, dev, logger = start_run(cfg, args, f"meta_tune_{cfg.get('train_dataset')}")

    train_ds = build_dataset(cfg, "train_dataset")
    val_ds = build_dataset(cfg, "val_dataset") or train_ds
    tval_ds = build_dataset(cfg, "tval_dataset")  # optional second monitoring split
    visualize_datasets(logger, cfg, train_dataset=train_ds, val_dataset=val_ds,
                       tval_dataset=tval_ds)

    way = int(cfg.get("n_train_way", cfg.get("n_way", 5)))
    shot = int(cfg.get("n_train_shot", cfg.get("n_shot", 1)))
    query = int(cfg.get("n_train_query", cfg.get("n_query", 15)))
    ep_per_batch = int(cfg.get("ep_per_batch", 4))
    if mesh is not None and ep_per_batch % mesh.size("data"):
        raise ValueError(f"ep_per_batch={ep_per_batch} must divide evenly over the mesh "
                         f"data axis ({mesh.size('data')})")
    train_batches = int(cfg.get("train_batches", 100))
    epochs = int(cfg.get("max_epoch", 100))

    name = cfg.get("model", "meta-baseline")
    head = models.make(
        name,
        encoder=cfg.get("model_args.encoder", "visformer_micro_80"),
        encoder_args=dict(cfg.get("model_args.encoder_args", {}) or {}),
        temp=float(cfg.get("model_args.temp", 10.0)),
        temp_learnable=bool(cfg.get("model_args.temp_learnable", True)),
        dtype=model_dtype(cfg), device=dev, seed=args.seed,
    )
    check_standard_episodic(head, name)
    load_enc = cfg.get("load_encoder")
    if load_enc:
        load_encoder_from_checkpoint(load_enc, head.encoder,
                                     cfg.get("model_args.encoder", "visformer_micro_80"))
    else:
        logger.log("WARNING: no 'load_encoder': encoder randomly initialized")

    if mesh is not None:  # column-parallel wide layers over `model` (none at size 1)
        param_shardings(mesh, head)
    state = TrainState(head, build_optimizer(cfg, head.parameters()))
    epoch_fn = make_meta_tune_epoch(
        way, shot, query, ep_per_batch, freeze_bn=bool(cfg.get("freeze_bn", False)),
        mean=train_ds.mean, std=train_ds.std)

    # A train split over the budget stays on the host: an epoch only touches
    # train_batches*ep_per_batch*way*(shot+query) images, so that subset is
    # gathered on the host and uploaded as one fixed-shape array per epoch.
    budget = gpu_budget_gb(cfg)
    stage = needs_staging(train_ds.images, budget)
    epoch_cap = min(train_batches * ep_per_batch * way * (shot + query), len(train_ds))
    if stage:
        cap_bytes = epoch_cap * (train_ds.images.nbytes // len(train_ds))
        if cap_bytes > budget * 2 ** 30:
            raise ValueError(
                f"one epoch touches {cap_bytes / 2**30:.1f} GiB of episode images > "
                f"gpu_budget_gb={budget:g}; lower train_batches/ep_per_batch or raise "
                "the budget")
        logger.log(f"epoch-subset staging: dataset {train_ds.images.nbytes / 2**30:.1f} GiB "
                   f"> {budget:g} GiB; staging <= {epoch_cap} images/epoch")
        images_dev = None
    else:
        images_dev = upload_images(train_ds.images, dev)
    sampler = EpisodeSampler(train_ds.labels, train_batches, way, shot + query, ep_per_batch)
    n_way, n_shot = int(cfg.get("n_way", 5)), int(cfg.get("n_shot", 1))
    n_query = int(cfg.get("n_query", 15))
    val_episodes = int(cfg.get("val_episodes", 200))

    # the monitoring splits stay on the device across epochs
    val_indices = None
    if val_ds is train_ds and stage:
        # the fixed-seed val episodes repeat every epoch: stage just their images
        idx_val = sample_episode_indices(
            val_ds, val_episodes, n_way, n_shot + n_query, ep_per_batch, seed=0)
        subset, val_indices = epoch_subset(val_ds.images, idx_val, len(np.unique(idx_val)))
        val_images_dev = torch.from_numpy(subset).to(dev)
    elif val_ds is train_ds:
        val_images_dev = images_dev
    else:
        val_images_dev = upload_images(val_ds.images, dev)
    tval_images_dev = upload_images(tval_ds.images, dev) if tval_ds is not None else None
    policy = CheckpointPolicy(logger.save_dir, save_epoch=cfg.get("save_epoch"))

    resume_dir = os.path.join(logger.save_dir, "resume")
    start_epoch = 1
    if cfg.get("resume") and has_checkpoint(resume_dir):
        saved, meta = load_variables(resume_dir, map_location=dev)
        state.load_state_dict(saved)
        start_epoch = int(meta.get("epoch", 0)) + 1
        logger.log(f"resumed full train state from epoch {start_epoch - 1}")
    if start_epoch > epochs:
        logger.log(f"nothing left to do: resumed at epoch {start_epoch - 1} of {epochs}")

    def validate(ds, n_episodes, images, indices=None):
        head.eval()
        acc, ci, _ = evaluate(
            head, ds, n_episodes=n_episodes, way=n_way, shot=n_shot, query=n_query,
            ep_per_batch=ep_per_batch, seed=0, images_dev=images, indices=indices,
            device=dev, mesh=mesh)
        return acc, ci

    for epoch in range(start_epoch, epochs + 1):
        t0 = time.time()
        lr = state.optimizer.set_epoch(epoch - 1)
        # per-epoch seeded episode draws
        idx = np.stack(list(sampler.epoch(rng_mod.np_rng(args.seed, epoch)))).astype(np.int64)
        if stage:
            imgs_epoch, idx = epoch_subset(train_ds.images, idx, epoch_cap)
            imgs_dev_e = torch.from_numpy(imgs_epoch).to(dev)
        else:
            imgs_dev_e = images_dev
        with use_mesh(mesh):
            ms = epoch_fn(state, imgs_dev_e, torch.from_numpy(idx.astype(np.int64)).to(dev),
                          (args.seed, epoch))
        m = metrics_mean(ms)  # the fetch completes the epoch ...
        del imgs_dev_e        # ... so a staged subset can go before validation
        line = f"epoch {epoch} lr={lr:.3g} train loss={m['loss']:.4f} acc={m['acc']:.4f}"

        acc, ci = validate(val_ds, val_episodes, val_images_dev, val_indices)
        line += f" | val {n_way}w{n_shot}s acc={acc:.4f} +- {ci:.4f}"
        extra = {}
        if tval_ds is not None:
            tacc, tci = validate(tval_ds, int(cfg.get("tval_episodes", 500)), tval_images_dev)
            line += f" | tval acc={tacc:.4f} +- {tci:.4f}"
            extra["tval_acc"] = tacc
        logger.log(line + f" ({time.time() - t0:.1f}s)")
        logger.metrics(epoch, **m, val_acc=acc, **extra)
        policy.on_epoch(epoch, state.variables,
                        {"model": "meta-baseline", "encoder": cfg.get("model_args.encoder")},
                        va=acc)
        save_variables(resume_dir, state.state_dict(), {"epoch": epoch})
    return state


if __name__ == "__main__":
    main(*parse_args("phase-3a SUN-M meta-tuning (PyTorch/CUDA)"))
