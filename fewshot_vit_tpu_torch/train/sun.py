"""Phase 2: SUN meta-training, self-promoted supervision (counterpart:
``fewshot_vit_tpu/train/sun.py``).

A token-label student learns from global CE plus ``token_label_weight``
times a soft cross-entropy of its patch-token logits against soft labels
that a FROZEN teacher (the phase-1 classifier re-wrapped as a token-label
model, ``load:``) gives every patch of the weak view. The teacher is a
module of its own, ``requires_grad_(False)``, in eval mode, optionally in
another dtype (``teacher_dtype``); with ``use_pallas_attn`` its stage-2
attention runs through the fused-MHSA kernel inside every training step,
while the student's training forward stays on the einsum path. The
location-aware dual view (``augment: dual``) runs on the card. Validation
is few-shot cosine matching every ``eval_fs_epoch`` epochs (``max-va`` on
``fsa-1``); checkpoints and resume as in the other trainers.

Run: ``python -m fewshot_vit_tpu_torch.train.sun --config CONFIG.yaml
[--device cpu]``; the configuration keys are the JAX package's.
"""

from __future__ import annotations

import os
import time
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..checkpoint.io import CheckpointPolicy, has_checkpoint, load_variables, save_variables
from ..core import rng as rng_mod
from ..core.registry import models
from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
from ..data.staging import upload_images
from ..heads import token_label as _heads  # noqa: F401  (registers the heads)
from ..parallel.mesh import param_shardings, use_mesh
from .loop import batch_indices, make_sun_epoch, metrics_mean
from .runner import (
    build_dataset,
    build_optimizer,
    fs_eval,
    model_dtype,
    parse_args,
    start_run,
    visualize_augmented,
    visualize_datasets,
)
from .state import TrainState


def assemble_teacher_variables(model: nn.Module, classifier_ckpt: Mapping[str, torch.Tensor]
                               ) -> nn.Module:
    """Fill a token-label model from a phase-1 classifier checkpoint: the
    encoder and the global classifier are copied, ``classifier_local`` keeps
    its initialization (the teacher never uses it). Every copied key must
    exist in ``model`` with the same shape."""
    sd = model.state_dict()
    for k, v in classifier_ckpt.items():
        if k.startswith(("encoder.", "classifier.")):
            if k not in sd or sd[k].shape != v.shape:
                raise KeyError(f"checkpoint entry {k!r} {tuple(v.shape)} has no place in "
                               f"the token-label model")
            sd[k] = v
    model.load_state_dict(sd)
    return model


def main(cfg, args) -> TrainState:
    mesh, dev, logger = start_run(cfg, args, f"sun_{cfg.get('train_dataset')}")

    train_ds = build_dataset(cfg, "train_dataset")
    fs_ds = build_dataset(cfg, "fs_dataset")
    visualize_datasets(logger, cfg, train_dataset=train_ds, fs_dataset=fs_ds)
    n_classes = train_ds.n_classes
    img = int(cfg.get("image_size", 80))
    encoder_args = dict(cfg.get("model_args.encoder_args", {}) or {})
    encoder_args.setdefault("img_size", img)

    def make_token_label(dtype, seed):
        return models.make("token-label", encoder=cfg.get("model_args.encoder", "visformer_micro_80"),
                           encoder_args=encoder_args, classifier_args={"n_classes": n_classes},
                           dtype=dtype, device=dev, seed=seed)

    student = make_token_label(model_dtype(cfg), args.seed)
    # the frozen teacher only produces top-k soft labels, so it may run at
    # lower precision than the student (`teacher_dtype: bfloat16`)
    teacher = make_token_label(
        model_dtype(cfg, key="teacher_dtype", default=str(cfg.get("model_args.dtype", "float32"))),
        args.seed + 1)
    load_path = cfg.get("load")
    if load_path:
        ck, _ = load_variables(load_path, map_location=dev)
        assemble_teacher_variables(teacher, ck)
        if bool(cfg.get("init_student_from_teacher", True)):
            assemble_teacher_variables(student, ck)
    else:
        logger.log("WARNING: no 'load' checkpoint — teacher is randomly initialized")
    teacher.requires_grad_(False).eval()
    if mesh is not None:  # the student's wide layers over `model`; the teacher stays whole
        param_shardings(mesh, student)

    batch_size = int(cfg.get("batch_size", 512))
    epochs = int(cfg.get("max_epoch", 100))
    state = TrainState(student, build_optimizer(cfg, student.parameters(), batch_size))

    dual_view_fn = None
    if cfg.get("augment", "dual") == "dual":
        from ..data.augment import make_dual_view_fn

        dual_view_fn = make_dual_view_fn(train_ds.mean, train_ds.std, out_size=img,
                                         strong_prob=float(cfg.get("strong_prob", 0.5)))
        visualize_augmented(logger, cfg, train_ds, dual_view_fn, train_ds.mean, train_ds.std,
                            dev, views=("strong", "weak"))
    epoch_fn = make_sun_epoch(
        dual_view_fn, train_ds.mean, train_ds.std, remat=bool(cfg.get("remat", False)),
        soft_k=int(cfg.get("tl_soft_k", 5)), bg_tokens=int(cfg.get("bg_token_num", 10)),
        token_weight=float(cfg.get("token_label_weight", 0.5)))
    images_dev = upload_images(train_ds.images, dev)
    labels_dev = torch.from_numpy(train_ds.labels.astype(np.int64)).to(dev)
    fs_images = upload_images(fs_ds.images, dev) if fs_ds is not None else None

    policy = CheckpointPolicy(logger.save_dir, save_epoch=cfg.get("save_epoch"))
    eval_fs_epoch = int(cfg.get("eval_fs_epoch", 5) or 0)

    resume_dir = os.path.join(logger.save_dir, "resume")
    start_epoch = 1
    if cfg.get("resume") and has_checkpoint(resume_dir):
        saved, meta = load_variables(resume_dir, map_location=dev)
        state.load_state_dict(saved)
        start_epoch = int(meta.get("epoch", 0)) + 1
        logger.log(f"resumed full train state from epoch {start_epoch - 1}")
    if start_epoch > epochs:
        logger.log(f"nothing left to do: resumed at epoch {start_epoch - 1} of {epochs}")

    for epoch in range(start_epoch, epochs + 1):
        t0 = time.time()
        state.optimizer.set_epoch(epoch - 1)
        idx = batch_indices(len(train_ds), batch_size, rng_mod.np_rng(args.seed, epoch))
        with use_mesh(mesh):
            ms = epoch_fn(state, teacher, images_dev, labels_dev,
                          torch.from_numpy(idx.astype(np.int64)).to(dev), (args.seed, epoch))
        m = metrics_mean(ms)
        line = (f"epoch {epoch} loss={m['loss']:.4f} cls={m['cls_loss']:.4f} "
                f"token={m['token_loss']:.4f} acc={m['acc']:.4f}")

        va = None
        if fs_ds is not None and eval_fs_epoch and epoch % eval_fs_epoch == 0:
            fm = fs_eval(student.encoder, fs_ds, n_episodes=int(cfg.get("eval_fs_episodes", 200)),
                         images_dev=fs_images, mesh=mesh)
            va = fm.get("fsa-1")
            line += " | " + " ".join(f"{k}={v:.4f}" for k, v in fm.items())
            logger.metrics(epoch, **fm)

        logger.log(line + f" ({time.time() - t0:.1f}s)")
        logger.metrics(epoch, **m)
        policy.on_epoch(epoch, state.variables,
                        {"model": "token-label", "n_classes": n_classes,
                         "encoder": cfg.get("model_args.encoder")}, va=va)
        save_variables(resume_dir, state.state_dict(), {"epoch": epoch})
    return state


if __name__ == "__main__":
    main(*parse_args("phase-2 SUN meta-training (PyTorch/CUDA)"))
