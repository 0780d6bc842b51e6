"""Phase 1: supervised whole-classification pretraining of the teacher
(counterpart: ``fewshot_vit_tpu/train/pretrain.py``).

CE over all base classes, AdamW with a batch-scaled rate and a cosine
warmup schedule (or SAM around a base optimizer, ``optimizer: sam``), the
device-side ``cropaug`` pipeline, an optional EMA shadow (``ema_decay``,
checkpointed under ``ema/``), per-epoch validation CE, few-shot validation
every ``eval_fs_epoch`` epochs through a shared-encoder MetaBaseline view
(and DeepEMD episodes with ``eval_emd``), ``epoch-last`` / ``epoch-N`` /
``max-va`` checkpoints, full-state resume and the extra plain epoch
``epoch_ex``. A train split over ``gpu_budget_gb`` streams through the card
in chunks (``data.staging.EpochStager``). With ``use_pallas_attn`` the
validation forwards run their stage-2 attention through the fused-MHSA
kernel; the training forwards never do (training mode).

Run: ``python -m fewshot_vit_tpu_torch.train.pretrain --config CONFIG.yaml
[--device cpu]``; the configuration keys are the JAX package's.
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from ..checkpoint.io import CheckpointPolicy, has_checkpoint, save_variables
from ..core import rng as rng_mod
from ..core.registry import models
from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
from ..data.staging import EpochStager, gpu_budget_gb, needs_staging, upload_images
from ..heads import classifier as _heads  # noqa: F401  (registers the heads)
from ..parallel.mesh import param_shardings, use_mesh
from .loop import batch_indices, eval_metrics, make_eval_ce_epoch, make_pretrain_epoch, metrics_mean
from .runner import (
    build_dataset,
    build_optimizer,
    emd_fs_eval,
    fs_eval,
    model_dtype,
    parse_args,
    profile_epoch,
    start_run,
    visualize_augmented,
    visualize_datasets,
)
from .state import TrainState, resume_train_state


def main(cfg, args) -> TrainState:
    mesh, dev, logger = start_run(cfg, args, f"pretrain_{cfg.get('train_dataset')}")

    train_ds = build_dataset(cfg, "train_dataset")
    val_ds = build_dataset(cfg, "val_dataset")
    fs_ds = build_dataset(cfg, "fs_dataset")
    visualize_datasets(logger, cfg, train_dataset=train_ds, val_dataset=val_ds,
                       fs_dataset=fs_ds)
    n_classes = train_ds.n_classes
    # the model's input size is the post-augmentation size, not the stored one
    img = int(cfg.get("image_size", 80 if cfg.get("augment") else train_ds.images.shape[1]))
    encoder_args = dict(cfg.get("model_args.encoder_args", {}) or {})
    encoder_args.setdefault("img_size", img)
    model = models.make(
        cfg.get("model", "classifier"),
        encoder=cfg.get("model_args.encoder", "visformer_micro_80"),
        encoder_args=encoder_args,
        classifier=cfg.get("model_args.classifier", "linear-classifier"),
        classifier_args={"n_classes": n_classes},
        dtype=model_dtype(cfg), device=dev, seed=args.seed,
    )

    batch_size = int(cfg.get("batch_size", 512))
    epochs = int(cfg.get("max_epoch", 100))
    # the reference's ModelEma, opt-in: `ema_decay: 0.9997`
    ema_decay = float(cfg.get("ema_decay", 0) or 0)
    if mesh is not None:  # column-parallel wide layers over `model` (none at size 1)
        param_shardings(mesh, model)
    state = TrainState(model, build_optimizer(cfg, model.parameters(), batch_size),
                       ema=bool(ema_decay))

    budget = gpu_budget_gb(cfg)
    stager = None
    if needs_staging(train_ds.images, budget):
        stager = EpochStager(train_ds.images, train_ds.labels, batch_size, budget, dev)
        logger.log(f"GPU staging: {train_ds.images.nbytes / 2**30:.1f} GiB dataset > "
                   f"{budget:g} GiB budget -> {stager.n_chunks} chunks/epoch "
                   f"x {stager.chunk_imgs} imgs")
        images_dev = labels_dev = None
    else:
        images_dev = upload_images(train_ds.images, dev)
        labels_dev = torch.from_numpy(train_ds.labels.astype(np.int64)).to(dev)

    preprocess_fn = None
    if cfg.get("augment") == "cropaug":
        from ..data.augment import make_cropaug_fn

        preprocess_fn = make_cropaug_fn(train_ds.mean, train_ds.std, out_size=img)
        visualize_augmented(logger, cfg, train_ds, preprocess_fn, train_ds.mean, train_ds.std,
                            dev)
    sam_kw = {}
    if cfg.get("optimizer") == "sam":
        oargs = dict(cfg.get("optimizer_args", {}) or {})
        sam_kw = {"sam_rho": float(oargs.get("sam_rho", 0.05)),
                  "sam_adaptive": bool(oargs.get("adaptive", False))}
        logger.log(f"SAM pretraining: {sam_kw}")
    remat = bool(cfg.get("remat", False))
    epoch_fn = make_pretrain_epoch(preprocess_fn, train_ds.mean, train_ds.std,
                                   ema_decay=ema_decay or None, remat=remat, **sam_kw)

    def run_epoch(fn, epoch_i):
        """One epoch through ``fn``, in chunks when the split is staged."""
        rng = rng_mod.np_rng(args.seed, epoch_i)
        if stager is None:
            idx = torch.from_numpy(batch_indices(len(train_ds), batch_size, rng)
                                   .astype(np.int64)).to(dev)
            return metrics_mean(fn(state, images_dev, labels_dev, idx, (args.seed, epoch_i)))
        chunks = []
        for ci, (imgs_c, labels_c, idx_c) in enumerate(stager.epoch(rng)):
            chunks.append(fn(state, imgs_c, labels_c, idx_c, (args.seed, epoch_i, ci)))
            del imgs_c, labels_c  # never two chunks on the card
        return metrics_mean({k: torch.cat([c[k] for c in chunks]) for k in chunks[0]})

    eval_fn = make_eval_ce_epoch(train_ds.mean, train_ds.std, n_valid=len(val_ds)) if val_ds else None
    val_images = upload_images(val_ds.images, dev) if val_ds else None
    val_labels = torch.from_numpy(val_ds.labels.astype(np.int64)).to(dev) if val_ds else None
    fs_images = upload_images(fs_ds.images, dev) if fs_ds is not None else None

    def val_ce(module):
        vidx = batch_indices(len(val_ds), min(batch_size, len(val_ds)), rng_mod.np_rng(0, 0),
                             drop_last=False)
        return eval_metrics(eval_fn(module, val_images, val_labels,
                                    torch.from_numpy(vidx.astype(np.int64)).to(dev)))

    policy = CheckpointPolicy(logger.save_dir, save_epoch=cfg.get("save_epoch"))
    eval_fs_epoch = int(cfg.get("eval_fs_epoch", 5) or 0)
    meta = {"model": "classifier", "n_classes": n_classes,
            "encoder": cfg.get("model_args.encoder")}

    resume_dir = os.path.join(logger.save_dir, "resume")
    start_epoch = 1
    if cfg.get("resume") and has_checkpoint(resume_dir):
        state, saved_meta, note = resume_train_state(resume_dir, state, map_location=dev)
        start_epoch = int(saved_meta.get("epoch", 0)) + 1
        logger.log(f"resumed full train state from epoch {start_epoch - 1}")
        if note:
            logger.log(note)
    if start_epoch > epochs:
        logger.log(f"nothing left to do: resumed at epoch {start_epoch - 1} of {epochs}")

    # the EMA shadow is evaluated and checkpointed like any model (ema/)
    ema_policy = CheckpointPolicy(os.path.join(logger.save_dir, "ema")) if ema_decay else None
    ema_model = copy.deepcopy(model) if ema_decay else None

    for epoch in range(start_epoch, epochs + 1):
        t0 = time.time()
        state.optimizer.set_epoch(epoch - 1)
        with profile_epoch(args, epoch), use_mesh(mesh):
            m = run_epoch(epoch_fn, epoch)
        line = f"epoch {epoch} train loss={m['loss']:.4f} acc={m['acc']:.4f}"

        va = None
        if eval_fn is not None:
            vm = val_ce(model)
            va = vm["acc"]
            line += f" | val loss={vm['loss']:.4f} acc={va:.4f}"

        if fs_ds is not None and eval_fs_epoch and epoch % eval_fs_epoch == 0:
            fm = fs_eval(model.encoder, fs_ds, n_episodes=int(cfg.get("eval_fs_episodes", 200)),
                         images_dev=fs_images, mesh=mesh)
            if cfg.get("eval_emd"):
                # SUN-D-style DeepEMD-episode validation during CE pretraining
                fm.update(emd_fs_eval(
                    model.encoder, fs_ds, n_episodes=int(cfg.get("eval_emd_episodes", 100)),
                    mode=cfg.get("eval_emd_mode", "fcn"), images_dev=fs_images))
            line += " | " + " ".join(f"{k}={v:.4f}" for k, v in fm.items())
            logger.metrics(epoch, **fm)

        ema_va = None
        if ema_policy is not None:
            ema_model.load_state_dict({**model.state_dict(), **state.ema_params})
            if eval_fn is not None:
                ema_va = val_ce(ema_model)["acc"]
                line += f" | ema val acc={ema_va:.4f}"

        logger.log(line + f" ({time.time() - t0:.1f}s)")
        logger.metrics(epoch, **m, **({"val_acc": va} if va is not None else {}),
                       **({"ema_val_acc": ema_va} if ema_va is not None else {}))
        policy.on_epoch(epoch, state.variables, meta, va=va)
        if ema_policy is not None:
            ema_policy.on_epoch(epoch, state.ema_variables, {**meta, "ema_decay": ema_decay},
                                va=ema_va)
        save_variables(resume_dir, state.state_dict(), {"epoch": epoch, "ema": bool(ema_decay)})

    if cfg.get("epoch_ex"):
        # the reference's extra epoch with the default transform (epoch-ex):
        # the same step options, only the augmentation dropped
        plain_fn = make_pretrain_epoch(None, train_ds.mean, train_ds.std,
                                       ema_decay=ema_decay or None, remat=remat, **sam_kw)
        state.optimizer.set_epoch(epochs)
        with use_mesh(mesh):
            m = run_epoch(plain_fn, epochs + 1)
        logger.log(f"epoch-ex train loss={m['loss']:.4f} acc={m['acc']:.4f}")
        save_variables(os.path.join(logger.save_dir, "epoch-ex"), state.variables,
                       {**meta, "epoch": "ex"})
        if ema_decay:
            save_variables(os.path.join(logger.save_dir, "ema", "epoch-ex"), state.ema_variables,
                           {**meta, "epoch": "ex", "ema_decay": ema_decay})
    return state


if __name__ == "__main__":
    main(*parse_args("phase-1 teacher pretraining (PyTorch/CUDA)"))
