"""Phase 3b (SUN-D): DeepEMD meta-tuning (counterpart:
``fewshot_vit_tpu/train/meta_tune_emd.py``).

Episodic CE over EMD-matching logits, Nesterov SGD (momentum 0.9, weight
decay 5e-4 on every parameter) with StepLR, task batches of ``bs`` episodes
with the reference's per-episode NaN rule, SFC prototype refinement for
shot > 1, BN frozen on running statistics, fixed validation episodes,
``max-va`` checkpoints, full-state resume and the inline final test that
appends ``results.txt``. With ``solver: sinkhorn_pallas`` the training
forward sends its flows through the CUDA Sinkhorn kernel
(``kernels/sinkhorn.py``); the flows are constants of the graph, so there is
no backward kernel. ``solver: exact`` trains and validates with the C++
simplex's flows, computed on the host (``heads/deepemd.py::exact_flows``),
as JAX accepts it. ``visualize_datasets: true`` writes a grid PNG of each split.

Episode index order is the reference's INTERLEAVED layout: index t*way + w
is class w, item t; query labels are ``tile(arange(way), query)``.

Run: ``python -m fewshot_vit_tpu_torch.train.meta_tune_emd --config
CONFIG.yaml [--device cpu]``; the configuration keys are the JAX package's.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core import rng as rng_mod
from ..core.rng import DEFAULT_SEED, torch_generator
from ..data.patches import draw_grid_ratios, grid_patches, sampling_patches
from ..data.transforms import normalize
from ..heads.deepemd import sfc_refine, sfc_refine_explicit
from ..models.common import draws_from, frozen_bn
from ..ops.metric import compute_acc
from .loop import metrics_mean, stack_metrics
from .optim import ScheduledOptimizer, multistep_schedule, zero_nan_tensor
from .state import TrainState


def make_patch_fn(mode: str, patch_list, patch_ratio: float, out_size: int,
                  train: bool, num_patch: int = 9) -> Callable:
    """``fn(images uint8 (B, H, W, 3), generator=None, **draws)`` -> model input
    (B[, P], out, out, 3) float in [0, 255].

    ``grid``: at the fixed ``patch_ratio`` in eval; in training at ratios drawn
    per image and level from ``generator``, or injected as ``ratios=`` (B,
    n_levels). ``sampling``: ``num_patch`` random resized crops from
    ``generator``, or from ``uniforms=`` (num_patch, 4, B). ``fcn``: the image."""
    if mode == "grid":
        patch_list = tuple(int(g) for g in patch_list)

        def fn(images, generator=None, ratios=None):
            if train and ratios is None:
                ratios = draw_grid_ratios(generator, images.shape[0], len(patch_list),
                                          images.device)
            return grid_patches(images, patch_list,
                                ratios if train else float(patch_ratio), out_size)
    elif mode == "sampling":
        def fn(images, generator=None, uniforms=None):
            return sampling_patches(generator, images, num_patch, out_size, uniforms=uniforms)
    elif mode == "fcn":
        def fn(images, generator=None):
            return images.to(torch.float32)
    else:
        raise ValueError(mode)
    return fn


def episode_logits(head, nodes: torch.Tensor, way: int, shot: int, sfc: bool,
                   sfc_kw: dict, episode_ids: Sequence[int], seed: int,
                   perms: Optional[torch.Tensor] = None,
                   explicit_sfc: bool = False) -> torch.Tensor:
    """nodes (E, way*(shot+query), N, C) in the interleaved layout -> logits
    (E, way*query, way): shot-mean prototypes, SFC-refined for shot > 1 (the
    refined prototype is outside the autograd graph; ``explicit_sfc`` takes
    ``sfc_refine_explicit``, the traceable form), then EMD matching.
    Shared by training, the direct and the cached eval, and the export."""
    k = way * shot
    e = nodes.shape[0]
    proto = nodes[:, :k].reshape(e, shot, way, *nodes.shape[2:]).mean(dim=1)
    if sfc and shot > 1:
        refine = sfc_refine_explicit if explicit_sfc else sfc_refine
        proto = refine(proto, nodes[:, :k], way, shot, episode_ids=episode_ids,
                       seed=seed, perms=perms, **sfc_kw)
    return head.meta(proto, nodes[:, k:])


def make_emd_episode_fn(head, way: int, shot: int, query: int, patch_fn: Callable,
                        mean, std, sfc: bool, sfc_kw: Optional[dict] = None,
                        train: bool = False, remat: bool = False,
                        seed: int = DEFAULT_SEED, explicit_sfc: bool = False) -> Callable:
    """``fn(images uint8 (E, way*(shot+query), H, W, 3), episode_ids (E,),
    key=None, perms=None, **draws)`` -> logits (E, way*query, way),
    re-encoding every image of the episodes.

    ``episode_ids`` are global episode indices: they seed the SFC shuffles
    (unless ``perms`` injects them), so an episode's logits do not depend on
    the batch it runs in. ``key`` is an integer tuple that seeds the call's
    generators, one for the patch draws and one for the dropout and drop-path
    masks (default: ``(seed, episode_ids[0])``); ``draws`` go to the patch
    function (``ratios=``, ``uniforms=``).

    ``train=True``: the head is put in training mode, so dropout and
    drop-path are live, while every BN runs on its frozen running statistics
    (per-episode batch statistics would diverge episode by episode). The
    caller holds grad mode. ``remat=True`` wraps the encoder in
    ``torch.utils.checkpoint``: the backward pass recomputes its activations
    (the mask generator is re-seeded inside, so both passes draw the same).
    ``explicit_sfc=True`` refines with ``sfc_refine_explicit`` (closed-form
    gradients, ``scan`` loops): the form ``torch.export`` traces, with the
    perms passed as ``perms=`` (``eval/export.py`` bakes them from ``seed``)."""
    sfc_kw = dict(sfc_kw or {})

    def fn(images_u8: torch.Tensor, episode_ids: Sequence[int],
           key: Optional[Sequence[int]] = None, perms: Optional[torch.Tensor] = None,
           **draws) -> torch.Tensor:
        e, n = images_u8.shape[:2]
        dev = images_u8.device
        key = tuple(key) if key is not None else (seed, int(episode_ids[0]))
        flat = images_u8.reshape(e * n, *images_u8.shape[2:])
        x = normalize(patch_fn(flat, torch_generator(dev, *key, 1), **draws), mean, std)
        if not train:
            nodes = head.encode_nodes(x)
        else:
            head.train()

            def encode(x):
                with frozen_bn(), draws_from(torch_generator(dev, *key, 2)):
                    return head.encode_nodes(x)

            if remat:
                from torch.utils.checkpoint import checkpoint

                nodes = checkpoint(encode, x, use_reentrant=False, preserve_rng_state=False)
            else:
                nodes = encode(x)
        return episode_logits(head, nodes.reshape(e, n, *nodes.shape[1:]), way, shot,
                              sfc, sfc_kw, episode_ids, seed, perms, explicit_sfc)

    return fn


def validate_episode_mesh(mesh_shape, grad_accum, ep_per_batch):
    """The validator of ``mesh:`` episode parallelism, kept so that such a
    config fails with the JAX package's words; the mesh itself is not ported."""
    if grad_accum:
        raise ValueError(
            "mesh episode parallelism shards the vmapped task batch; it "
            "is incompatible with grad_accum=True (sequential episodes) — "
            "running the scan over a sharded mesh would reintroduce the "
            "replicated-grouped-conv image gather this path exists to "
            "prevent. Drop grad_accum — the mesh already bounds per-chip "
            "activation memory to one episode.")
    if "data" not in mesh_shape:
        raise ValueError(
            f"mesh {mesh_shape} has no 'data' axis — SUN-D episode "
            "parallelism shards the task batch over a data axis "
            "(e.g. mesh: {data: 8}). Tensor-parallel-only meshes belong to "
            "the pretrain/SUN phases.")
    if ep_per_batch % mesh_shape["data"]:
        raise ValueError(
            f"bs={ep_per_batch} must divide evenly over the mesh data "
            f"axis ({mesh_shape['data']})")


def make_emd_epoch_fn(episode_fn: Callable, labels: torch.Tensor, ep_per_batch: int,
                      grad_accum: bool = False, mesh=None) -> Callable:
    """``epoch(state, images u8 (N, H, W, 3), idx (S, E, way*(shot+query))
    interleaved, key) -> metrics`` (dict of (S,) device tensors); ``key`` is
    the integer tuple (seed, epoch), and episode ``e`` of step ``i`` draws from
    (seed, epoch, i, e).

    The task batch: the reference accumulates ``loss / bs`` over ``bs``
    episodes and steps once, running ``detect_grad_nan`` on the ACCUMULATED
    gradient after every episode: a tensor whose sum holds a NaN is zeroed,
    which also wipes the earlier episodes' share of it. So per tensor the
    final gradient is the sum over the episodes after the last one whose own
    gradient had a NaN, divided by ``bs``. That needs per-episode gradients.
    The JAX package has two forms with the same math, a ``vmap`` over the
    episodes (``grad_accum: false``) and a sequential scan (``true``). Here
    both values of ``grad_accum`` run the sequential form, which is the
    natural one for autograd: one backward per episode into a buffer of its
    own, ``zero_nan_tensor`` on the running sum, ``1 / bs`` at the end.
    Activation memory is that of one episode. Parameters a loss does not
    reach get a zero gradient, so weight decay still acts on them, as in the
    JAX package."""
    if mesh is not None:
        validate_episode_mesh(dict(mesh), grad_accum, ep_per_batch)
        from .runner import AUXILIARIES

        raise NotImplementedError(f"mesh episode parallelism {AUXILIARIES}")

    def epoch(state: TrainState, images: torch.Tensor, idx: torch.Tensor,
              key: Sequence[int]) -> Dict[str, torch.Tensor]:
        params = [p for p in state.module.parameters() if p.requires_grad]
        inv = 1.0 / ep_per_batch
        ms = []
        for i, idx_b in enumerate(idx):
            sums = [torch.zeros_like(p) for p in params]
            loss = torch.zeros((), device=images.device)
            acc = torch.zeros((), device=images.device)
            for e, idx_e in enumerate(idx_b):
                ep_id = (state.step * ep_per_batch) + e
                logits = episode_fn(images[idx_e][None], [ep_id], key=(*key, i, e))[0].float()
                loss_e = F.cross_entropy(logits, labels)
                grads = torch.autograd.grad(loss_e, params, allow_unused=True)
                sums = [zero_nan_tensor(s if g is None else s + g)
                        for s, g in zip(sums, grads)]
                loss = loss + loss_e.detach()
                acc = acc + compute_acc(logits.detach(), labels)
            for p, s in zip(params, sums):
                p.grad = s * inv
            state.optimizer.step()
            state.step += 1
            ms.append({"loss": loss * inv, "acc": acc * inv})
        return stack_metrics(ms)

    return epoch


def build_sund_optimizer(cfg, params) -> ScheduledOptimizer:
    """The reference's SUN-D recipe: NaN zeroing, then weight decay 5e-4 on
    EVERY parameter, then Nesterov SGD(momentum 0.9), with StepLR(step_size,
    gamma) stepped once per epoch, written as milestones at each multiple of
    ``step_size``."""
    epochs = int(cfg.get("max_epoch", 100))
    step_size = int(cfg.get("step_size", 10))
    lr = float(cfg.get("lr", 5e-4))
    sched = multistep_schedule(lr, list(range(step_size, epochs + 1, step_size)),
                               gamma=float(cfg.get("gamma", 0.5)))
    opt = torch.optim.SGD(list(params), lr=lr, momentum=0.9, nesterov=True,
                          weight_decay=float(cfg.get("weight_decay", 5e-4)))
    out = ScheduledOptimizer(opt, sched, zero_nan=True)
    out.set_epoch(0)
    return out


def interleaved(idx_flat: np.ndarray, n_ep: int, way: int, n_per: int) -> np.ndarray:
    """The sampler emits (E, way, n_per) class-major; SUN-D order is item-major."""
    return idx_flat.reshape(n_ep, way, n_per).transpose(0, 2, 1).reshape(n_ep, -1)


def main(cfg, args) -> TrainState:
    from ..checkpoint.io import CheckpointPolicy, has_checkpoint, load_variables, save_variables
    from ..core.device import resolve_device
    from ..core.log import RunLogger
    from ..core.registry import models
    from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
    from ..data.sampler import EpisodeSampler
    from ..data.staging import upload_images
    from ..eval.emd_eval import evaluate_emd, sample_emd_episode_indices
    from ..heads import deepemd as _heads  # noqa: F401  (registers the heads)
    from .runner import (
        build_dataset,
        check_single_device,
        load_encoder_from_checkpoint,
        model_dtype,
        save_dir_for,
        visualize_datasets,
    )

    dev = resolve_device(args.device)
    if cfg.get("mesh"):
        validate_episode_mesh({k: int(v) for k, v in dict(cfg.get("mesh")).items()},
                              bool(cfg.get("grad_accum", False)), int(cfg.get("bs", 1)))
    check_single_device(cfg)
    logger = RunLogger(save_dir_for(cfg, args, f"sund_{cfg.get('train_dataset')}"))
    logger.log(f"config: {cfg.to_dict()}")

    train_ds = build_dataset(cfg, "train_dataset")
    val_ds = build_dataset(cfg, "val_dataset") or train_ds
    visualize_datasets(logger, cfg, train_dataset=train_ds, val_dataset=val_ds)

    way = int(cfg.get("way", 5))
    shot = int(cfg.get("shot", 1))
    query = int(cfg.get("query", 15))
    ep_per_batch = int(cfg.get("bs", 1))  # the reference's task-batch accumulation
    mode = cfg.get("deepemd", "grid")
    img = int(cfg.get("image_size", 80))

    head = models.make(
        "deepemd",
        encoder=cfg.get("model_args.encoder", "visformer_micro_80"),
        encoder_args=dict(cfg.get("model_args.encoder_args", {}) or {}),
        temperature=float(cfg.get("temperature", 12.5)),
        solver_reg=float(cfg.get("solver_reg", 0.05)),
        solver_iters=int(cfg.get("solver_iters", 100)),
        solver=cfg.get("solver", "sinkhorn_detached"),
        feature_pyramid=cfg.get("feature_pyramid"),
        dtype=model_dtype(cfg), device=dev, seed=args.seed,
    )
    load_enc = cfg.get("load_encoder")
    if load_enc:
        load_encoder_from_checkpoint(load_enc, head.encoder,
                                     cfg.get("model_args.encoder", "visformer_micro_80"))
    else:
        logger.log("WARNING: no 'load_encoder': encoder randomly initialized")

    epochs = int(cfg.get("max_epoch", 100))
    train_batches = int(cfg.get("train_batches", 50))
    state = TrainState(head, build_sund_optimizer(cfg, head.parameters()))

    patch_kw = dict(patch_list=cfg.get("patch_list", [2, 3]),
                    patch_ratio=float(cfg.get("patch_ratio", 2.0)), out_size=img,
                    num_patch=int(cfg.get("num_patch", 9)))
    mean, std = train_ds.mean, train_ds.std
    sfc_kw = {"steps": int(cfg.get("sfc_update_step", 100)),
              "lr": float(cfg.get("sfc_lr", 0.1)),
              "batch_size": int(cfg.get("sfc_bs", 4))}
    episode_fn = make_emd_episode_fn(
        head, way, shot, query, make_patch_fn(mode, train=True, **patch_kw), mean, std,
        sfc=shot > 1, sfc_kw=sfc_kw, train=True, remat=bool(cfg.get("remat", False)),
        seed=args.seed)
    labels = torch.arange(way, device=dev).repeat(query)
    images_dev = upload_images(train_ds.images, dev)
    epoch_fn = make_emd_epoch_fn(episode_fn, labels, ep_per_batch,
                                 grad_accum=bool(cfg.get("grad_accum", False)))
    # do not hold the images twice when validating on the train split
    val_images = images_dev if val_ds is train_ds else upload_images(val_ds.images, dev)

    # grid and fcn eval patches are a fixed function of the image, so the
    # validation encodes each image's nodes once and gathers per episode
    # (identical logits, eval/emd_eval.py); ``sampling`` re-encodes
    cached = mode != "sampling"
    eval_epb = 16 if cached else 1

    def run_eval(ds, images, indices):
        head.eval()
        return evaluate_emd(
            head, ds, way=way, shot=shot, query=query, ep_per_batch=eval_epb, mode=mode,
            cached=cached, indices=indices, patch_list=patch_kw["patch_list"],
            patch_ratio=patch_kw["patch_ratio"], image_size=img,
            num_patch=patch_kw["num_patch"], sfc_kw=sfc_kw, images_dev=images,
            seed=args.seed, device=dev)

    train_sampler = EpisodeSampler(train_ds.labels, train_batches, way, shot + query,
                                   ep_per_batch)
    val_episodes = int(cfg.get("val_episode", 200))
    val_idx = sample_emd_episode_indices(val_ds, val_episodes, way, shot + query, seed=0)

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

    best_va, best_epoch = -float("inf"), 0
    for epoch in range(start_epoch, epochs + 1):
        t0 = time.time()
        lr = state.optimizer.set_epoch(epoch - 1)
        ep_rng = rng_mod.np_rng(args.seed, epoch)
        idx = np.stack([
            interleaved(train_sampler.batch(ep_rng), ep_per_batch, way, shot + query)
            for _ in range(train_batches)
        ]).astype(np.int64)
        ms = epoch_fn(state, images_dev, torch.from_numpy(idx).to(dev), (args.seed, epoch))
        m = metrics_mean(ms)

        va, ci, _ = run_eval(val_ds, val_images, val_idx)
        if va > best_va:
            best_va, best_epoch = va, epoch
        logger.log(
            f"epoch {epoch} lr={lr:.3g} train loss={m['loss']:.4f} acc={m['acc']:.4f} | "
            f"val {way}w{shot}s acc={va:.4f} +- {ci:.4f} ({time.time() - t0:.1f}s)")
        logger.metrics(epoch, **m, val_acc=va)
        policy.on_epoch(epoch, state.variables,
                        {"model": "deepemd", "deepemd": mode,
                         "encoder": cfg.get("model_args.encoder")}, va=va)
        save_variables(resume_dir, state.state_dict(), {"epoch": epoch})

    # inline final test: reload the best-val checkpoint, run the full test
    # protocol, append results.txt
    test_episodes = int(cfg.get("test_episode", 2000 if shot == 1 else 600))
    best_dir = os.path.join(logger.save_dir, "max-va")
    if test_episodes and has_checkpoint(best_dir):
        best_vars, best_meta = load_variables(best_dir, map_location=dev)
        last_vars = {k: v.clone() for k, v in head.state_dict().items()}
        head.load_state_dict(best_vars)
        test_ds = build_dataset(cfg, "test_dataset") or val_ds
        test_idx = sample_emd_episode_indices(test_ds, test_episodes, way, shot + query, seed=1)
        test_images = (val_images if test_ds is val_ds
                       else upload_images(test_ds.images, dev))
        m_t, ci_t, _ = run_eval(test_ds, test_images, test_idx)
        head.load_state_dict(last_vars)  # the returned state is the last epoch's
        # the max-va meta is authoritative: it survives resume, the local
        # best_va / best_epoch only cover this process's epochs
        best_va_saved = best_meta.get("val_acc", best_va)
        best_epoch_saved = best_meta.get("epoch", best_epoch)
        lines = [
            f"Val Best Epoch {best_epoch_saved}, best val Acc {float(best_va_saved):.4f}",
            f"Test Acc {m_t * 100:.4f} + {ci_t * 100:.4f}",
        ]
        logger.log(f"final test {way}w{shot}s ({test_episodes} episodes): "
                   f"acc={m_t * 100:.2f} +- {ci_t * 100:.2f} (%)")
        with open(os.path.join(logger.save_dir, "results.txt"), "a") as f:
            f.write("\n".join(lines) + "\n")
    return state


if __name__ == "__main__":
    from .runner import parse_args

    main(*parse_args("phase-3b SUN-D DeepEMD meta-tuning (PyTorch/CUDA)"))
