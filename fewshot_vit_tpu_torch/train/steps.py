"""Per-step training programs (counterpart: ``fewshot_vit_tpu/train/steps.py``):

  * ``make_pretrain_step``: phase 1, CE over all base classes;
  * ``make_sun_step``: phase 2, student CE plus a weighted soft token-label
    loss against labels from a frozen teacher;
  * ``make_meta_tune_step``: phase 3a, Meta-Baseline episodic CE.

A step takes uint8 device batches, an integer ``key`` (seed, epoch, step)
that seeds its generators (``core.rng.torch_generator``), runs one forward
in training mode, one backward and one optimizer step, and returns its
metrics as 0-d device tensors: nothing here waits for the card.

Under ``parallel.use_mesh(mesh)`` a step takes the GLOBAL batch, runs the
augmentation on all of it with the one generator every rank seeds alike,
keeps this rank's contiguous block (``local_block``), draws its dropout and
drop-path masks as this block's rows of the global draw (``shard_rows``),
normalizes with global-batch BN statistics, averages the gradients over the
``data`` axis before the optimizer step and returns the global batch's
metrics: the step of every rank equals the unsharded step.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import trace
from ..core.rng import torch_generator
from ..data.transforms import MEAN, STD, normalize
from ..models.common import draw_rows, draws_from, frozen_bn
from ..ops.episodes import make_nk_label
from ..ops.metric import compute_acc
from ..ops.token_label import generate_soft_label, soft_target_cross_entropy
from ..parallel.mesh import local_block, mean_metrics, shard_rows, sync_tensors
from .state import TrainState


@contextlib.contextmanager
def kept_bn_stats(module: nn.Module) -> Iterator[None]:
    """The BN running statistics as they are on entry are back in place on
    exit. A second forward over the same batch (SAM's second pass, the
    recomputation of a checkpointed forward) must not update them again:
    the JAX package keeps the first pass's statistics."""
    stats = [b for n, b in module.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    saved = [b.clone() for b in stats]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in zip(stats, saved):
                b.copy_(v)


def train_forward(module: nn.Module, x: torch.Tensor, key: Sequence[int],
                  remat: bool = False, **kwargs):
    """``module(x, **kwargs)`` with every dropout and drop-path mask drawn from
    ``torch_generator(device, *key)``. ``remat=True`` wraps it in
    ``torch.utils.checkpoint``: the backward recomputes the activations, the
    generator re-seeded so both passes draw the same masks (the caller keeps
    the BN statistics of the first pass with ``kept_bn_stats``)."""

    rows = shard_rows(x.shape[0])

    def fwd(x):
        with draws_from(torch_generator(x.device, *key)), draw_rows(*rows):
            return module(x, **kwargs)

    if remat:
        from torch.utils.checkpoint import checkpoint

        return checkpoint(fwd, x, use_reentrant=False, preserve_rng_state=False)
    return fwd(x)


def step_inputs(images_u8: torch.Tensor, key: Sequence[int], preprocess_fn, mean, std):
    """The augmentation pipeline with its generator (seed, epoch, step, 7), or
    plain normalization; under a mesh, this rank's block of the result."""
    if preprocess_fn is not None:
        return local_block(preprocess_fn(images_u8, torch_generator(images_u8.device, *key, 7)))
    return normalize(local_block(images_u8), mean, std)


def _backward_and_update(state: TrainState, loss: torch.Tensor, remat: bool) -> None:
    state.optimizer.zero_grad()  # sets the gradients to None: no device work
    with trace.span("train.backward"), \
            kept_bn_stats(state.module) if remat else contextlib.nullcontext():
        loss.backward()
    with trace.span("train.grad_sync"):
        sync_tensors([p.grad for p in state.module.parameters()])
    with trace.span("train.optimizer"):
        state.optimizer.step()
    state.step += 1


def make_pretrain_step(
    mean=MEAN, std=STD, ema_decay: Optional[float] = None,
    preprocess_fn: Optional[Callable] = None, remat: bool = False,
) -> Callable:
    """``step(state, images_u8 (B, H, W, 3), labels (B,), key) -> metrics``.

    ``preprocess_fn(images_u8, generator) -> float images`` is the device-side
    augmentation (default: plain normalization). ``ema_decay`` updates
    ``state.ema_params`` after each optimizer step. Metrics: ``loss``, ``acc``."""

    @trace.span("train.step")
    def step(state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor,
             key: Sequence[int]) -> Dict[str, torch.Tensor]:
        with trace.span("train.augment"):
            x = step_inputs(images_u8, key, preprocess_fn, mean, std)
        labels = local_block(labels.long())
        with trace.span("train.student"):
            state.module.train()
            logits = train_forward(state.module, x, key, remat)
            loss = F.cross_entropy(logits.float(), labels)
        _backward_and_update(state, loss, remat)
        if state.ema_params is not None and ema_decay:
            state.ema_update(ema_decay)
        return mean_metrics({"loss": loss.detach(),
                             "acc": compute_acc(logits.detach(), labels)})

    return step


def sun_targets(teacher: nn.Module, x_weak: torch.Tensor, smoothing: float = 0.1,
                soft_k: int = 5, bg_tokens: int = 10) -> torch.Tensor:
    """The frozen teacher's soft token labels (B, T, C + 1) for the weak view:
    the teacher in eval mode under ``no_grad`` (so a ``use_pallas_attn``
    teacher runs its stage-2 attention through the fused kernel), its dense
    map through the global classifier, then ``generate_soft_label``."""
    teacher.eval()
    with torch.no_grad():
        y_token, _, _ = teacher(x_weak, is_teacher=True)
        b, h, w, c = y_token.shape
        return generate_soft_label(y_token.reshape(b, h * w, c).float(), smoothing,
                                   soft_k, bg_tokens)


def sun_loss(student: nn.Module, x_strong: torch.Tensor, labels: torch.Tensor,
             soft: torch.Tensor, key: Sequence[int], token_weight: float = 0.5,
             remat: bool = False) -> Tuple[torch.Tensor, ...]:
    """The student's training forward on the strong view -> (loss, cls_loss,
    token_loss, global logits): CE of the global logits plus ``token_weight``
    times the soft cross-entropy of the (B, T, C + 1) token logits."""
    student.train()
    y_token, y, _ = train_forward(student, x_strong, key, remat)
    cls_loss = F.cross_entropy(y.float(), labels)
    token_loss = soft_target_cross_entropy(
        y_token.reshape(y_token.shape[0], -1, y_token.shape[-1]).float(), soft)
    return cls_loss + token_weight * token_loss, cls_loss, token_loss, y


def make_sun_step(
    soft_k: int = 5, bg_tokens: int = 10, token_weight: float = 0.5,
    smoothing: float = 0.1, mean=MEAN, std=STD,
    dual_view_fn: Optional[Callable] = None, remat: bool = False,
) -> Callable:
    """``step(state, teacher, strong_u8, weak_u8, labels, key) -> metrics``.

    The teacher (a ``TokenLabel``, frozen) labels the weak view's patches
    (``sun_targets``); the student in ``state`` learns from the strong view
    (``sun_loss``). ``dual_view_fn(images_u8, generator) -> (strong, weak)``
    is the device-side location-aware dual augmentation; with it, pass the
    SAME batch as ``strong_u8`` and ``weak_u8``. Metrics: ``loss``,
    ``cls_loss``, ``token_loss``, ``acc``."""

    @trace.span("train.step")
    def step(state: TrainState, teacher: nn.Module, strong_u8: torch.Tensor,
             weak_u8: torch.Tensor, labels: torch.Tensor,
             key: Sequence[int]) -> Dict[str, torch.Tensor]:
        with trace.span("train.augment"):
            if dual_view_fn is not None:
                xs, xw = dual_view_fn(strong_u8, torch_generator(strong_u8.device, *key, 7))
                xs, xw = local_block(xs), local_block(xw)
            else:
                xs = normalize(local_block(strong_u8), mean, std)
                xw = normalize(local_block(weak_u8), mean, std)
        labels = local_block(labels.long())
        with trace.span("train.teacher"):
            soft = sun_targets(teacher, xw, smoothing, soft_k, bg_tokens)
        with trace.span("train.student"):
            loss, cls_loss, token_loss, y = sun_loss(state.module, xs, labels, soft, key,
                                                     token_weight, remat)
        _backward_and_update(state, loss, remat)
        return mean_metrics({"loss": loss.detach(), "cls_loss": cls_loss.detach(),
                             "token_loss": token_loss.detach(),
                             "acc": compute_acc(y.detach(), labels)})

    return step


def make_meta_tune_step(
    way: int, query: int, ep_per_batch: int, mean=MEAN, std=STD,
    freeze_bn: bool = False, preprocess_fn: Optional[Callable] = None,
) -> Callable:
    """Episodic CE step for Meta-Baseline tuning.

    ``step(state, x_shot_u8 (E, way, shot, H, W, 3), x_query_u8 (E, way*query,
    H, W, 3), key) -> metrics``: one forward in training mode, the mean CE over
    ``logits.reshape(-1, way)`` in fp32, one backward, one optimizer step.
    ``key`` is the integer tuple (seed, epoch, step) that seeds the step's
    generators: one for the dropout and drop-path masks and, when
    ``preprocess_fn(images_u8, generator)`` is given, one each for shots and
    queries. ``freeze_bn``: BN on running statistics, never updated, the rest
    of the model still in training mode. Metrics are 0-d tensors on the
    device; nothing here synchronises with the host."""

    @trace.span("train.step")
    def step(state: TrainState, x_shot_u8: torch.Tensor, x_query_u8: torch.Tensor,
             key: Sequence[int]) -> Dict[str, torch.Tensor]:
        head, dev = state.module, x_shot_u8.device
        with trace.span("train.augment"):
            if preprocess_fn is not None:
                img = x_shot_u8.shape[3:]
                xs = preprocess_fn(x_shot_u8.reshape(-1, *img), torch_generator(dev, *key, 7))
                xs = local_block(xs.reshape(*x_shot_u8.shape[:3], *xs.shape[1:]))
                xq = preprocess_fn(x_query_u8.reshape(-1, *img),
                                   torch_generator(dev, *key, 7, 1))
                xq = local_block(xq.reshape(*x_query_u8.shape[:2], *xq.shape[1:]))
            else:
                xs = normalize(local_block(x_shot_u8), mean, std)
                xq = normalize(local_block(x_query_u8), mean, std)
        labels = make_nk_label(way, query, xs.shape[0], device=dev).reshape(-1)
        with trace.span("train.student"):
            head.train()
            # the head encodes cat(shots, queries): each segment is this rank's block
            rows = shard_rows(xs.shape[0] * xs.shape[1] * xs.shape[2],
                              xq.shape[0] * xq.shape[1])
            with draws_from(torch_generator(dev, *key)), draw_rows(*rows), \
                    (frozen_bn() if freeze_bn else contextlib.nullcontext()):
                logits = head(xs, xq)
            logits = logits.reshape(-1, way).float()
            loss = F.cross_entropy(logits, labels)
        _backward_and_update(state, loss, remat=False)
        return mean_metrics({"loss": loss.detach(),
                             "acc": compute_acc(logits.detach(), labels)})

    return step
