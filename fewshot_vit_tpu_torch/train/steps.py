"""Per-step training programs (counterpart: ``fewshot_vit_tpu/train/steps.py``).
Only the Meta-Baseline tuning step is ported so far."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.rng import torch_generator
from ..data.transforms import MEAN, STD, normalize
from ..models.common import draws_from, frozen_bn
from ..ops.episodes import make_nk_label
from ..ops.metric import compute_acc
from .state import TrainState


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

    def step(state: TrainState, x_shot_u8: torch.Tensor, x_query_u8: torch.Tensor,
             key: Sequence[int]) -> Dict[str, torch.Tensor]:
        head, dev = state.module, x_shot_u8.device
        labels = make_nk_label(way, query, ep_per_batch, device=dev).reshape(-1)
        if preprocess_fn is not None:
            img = x_shot_u8.shape[3:]
            xs = preprocess_fn(x_shot_u8.reshape(-1, *img), torch_generator(dev, *key, 7))
            xs = xs.reshape(*x_shot_u8.shape[:3], *xs.shape[1:])
            xq = preprocess_fn(x_query_u8.reshape(-1, *img), torch_generator(dev, *key, 7, 1))
            xq = xq.reshape(*x_query_u8.shape[:2], *xq.shape[1:])
        else:
            xs = normalize(x_shot_u8, mean, std)
            xq = normalize(x_query_u8, mean, std)
        head.train()
        with draws_from(torch_generator(dev, *key)), \
                (frozen_bn() if freeze_bn else contextlib.nullcontext()):
            logits = head(xs, xq)
        logits = logits.reshape(-1, way).float()
        loss = F.cross_entropy(logits, labels)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "acc": compute_acc(logits.detach(), labels)}

    return step
