"""Epoch-level programs (counterpart: ``fewshot_vit_tpu/train/loop.py``).

The train split lives on the device as uint8; an epoch is a plain Python loop
over steps, each gathering its batch by index. Per-step metrics stay on the
device during the epoch and come to the host once, in ``metrics_mean``, so
the loop never waits for the device between steps.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data.transforms import normalize
from ..ops.episodes import split_shot_query
from . import steps as steps_mod
from .state import TrainState


def stack_metrics(per_step: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """A list of per-step metric dicts -> one dict of (S,) device tensors."""
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def make_pretrain_epoch(preprocess_fn: Optional[Callable] = None, mean=None, std=None,
                        sam_rho: Optional[float] = None, sam_adaptive: bool = False,
                        ema_decay: Optional[float] = None, remat: bool = False) -> Callable:
    """``epoch(state, images u8 (N, H, W, 3), labels (N,), idx (S, B), key) ->
    metrics`` (dict of (S,) device tensors); step ``i`` draws from
    (``*key``, i).

    ``sam_rho`` switches the update to Sharpness-Aware Minimization (two
    forward-backward passes, ``train/sam.py``); ``ema_decay`` keeps the EMA
    shadow in ``state.ema_params`` (a state built with ``ema=True``)."""
    kw = {} if mean is None else {"mean": mean, "std": std}
    if sam_rho:
        if ema_decay:
            raise ValueError("ema_decay is not supported with the SAM step")
        if remat:
            raise ValueError("remat is not supported with the SAM step")
        from .sam import make_sam_pretrain_step

        step = make_sam_pretrain_step(float(sam_rho), bool(sam_adaptive), preprocess_fn, **kw)
    else:
        step = steps_mod.make_pretrain_step(
            ema_decay=float(ema_decay) if ema_decay else None, preprocess_fn=preprocess_fn,
            remat=remat, **kw)

    def epoch(state: TrainState, images: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor,
              key: Sequence[int]) -> Dict[str, torch.Tensor]:
        return stack_metrics([step(state, images[idx_b], labels[idx_b], (*key, i))
                              for i, idx_b in enumerate(idx)])

    return epoch


def make_sun_epoch(dual_view_fn: Optional[Callable] = None, mean=None, std=None,
                   remat: bool = False, **sun_kw) -> Callable:
    """``epoch(state, teacher, images u8, labels, idx (S, B), key) -> metrics``;
    ``sun_kw``: ``soft_k``, ``bg_tokens``, ``token_weight``, ``smoothing``."""
    kw = dict(sun_kw)
    if mean is not None:
        kw.update(mean=mean, std=std)
    step = steps_mod.make_sun_step(dual_view_fn=dual_view_fn, remat=remat, **kw)

    def epoch(state: TrainState, teacher: torch.nn.Module, images: torch.Tensor,
              labels: torch.Tensor, idx: torch.Tensor,
              key: Sequence[int]) -> Dict[str, torch.Tensor]:
        ms = []
        for i, idx_b in enumerate(idx):
            imgs = images[idx_b]
            ms.append(step(state, teacher, imgs, imgs, labels[idx_b], (*key, i)))
        return stack_metrics(ms)

    return epoch


def make_meta_tune_epoch(
    way: int, shot: int, query: int, ep_per_batch: int, freeze_bn: bool = False,
    preprocess_fn: Optional[Callable] = None, mean=None, std=None,
) -> Callable:
    """``epoch(state, images u8 (N, H, W, 3), idx (S, E*way*(shot+query)),
    key) -> metrics`` (dict of (S,) device tensors). ``key`` is the integer
    tuple (seed, epoch); step ``i`` draws from (seed, epoch, i)."""
    kw = {} if mean is None else {"mean": mean, "std": std}
    step = steps_mod.make_meta_tune_step(way, query, ep_per_batch, freeze_bn=freeze_bn,
                                         preprocess_fn=preprocess_fn, **kw)

    def epoch(state: TrainState, images: torch.Tensor, idx: torch.Tensor,
              key: Sequence[int]) -> Dict[str, torch.Tensor]:
        ms = []
        for i, idx_b in enumerate(idx):
            xs, xq = split_shot_query(images[idx_b], way, shot, query, ep_per_batch)
            ms.append(step(state, xs, xq, (*key, i)))
        return stack_metrics(ms)

    return epoch


def make_eval_ce_epoch(mean, std, n_valid: Optional[int] = None) -> Callable:
    """``epoch(model, images u8, labels, idx (S, B)) -> per-step sums``:
    ``loss_sum``, ``correct`` and ``n`` (each (S,)), the model in eval mode
    under ``no_grad``. ``n_valid`` is how many leading slots of the flattened
    ``idx`` grid are real samples: ``batch_indices(drop_last=False)`` cycles
    the permutation to fill the last batch, and those repeats are masked so
    every image counts once. Reduce with ``eval_metrics``."""

    @torch.no_grad()
    def epoch(model: torch.nn.Module, images: torch.Tensor, labels: torch.Tensor,
              idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        s, b = idx.shape
        total = n_valid if n_valid is not None else s * b
        mask = (torch.arange(s * b, device=idx.device).reshape(s, b) < total).float()
        model.eval()
        ms = []
        for idx_b, m_b in zip(idx, mask):
            logits = model(normalize(images[idx_b], mean, std))
            lab = labels[idx_b].long()
            ce = F.cross_entropy(logits.float(), lab, reduction="none")
            correct = (torch.argmax(logits, dim=-1) == lab).float()
            ms.append({"loss_sum": (ce * m_b).sum(), "correct": (correct * m_b).sum(),
                       "n": m_b.sum()})
        return stack_metrics(ms)

    return epoch


def eval_metrics(ms: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Exact loss and accuracy means from ``make_eval_ce_epoch``'s sums."""
    n = float(ms["n"].sum().item())
    return {"loss": float(ms["loss_sum"].sum().item()) / n,
            "acc": float(ms["correct"].sum().item()) / n}


def batch_indices(n: int, batch_size: int, rng: np.random.Generator,
                  drop_last: bool = True) -> np.ndarray:
    """Shuffled (steps, batch_size) index matrix for one epoch.
    ``drop_last=False`` cycles the permutation to fill the final batch."""
    perm = rng.permutation(n)
    n_steps = n // batch_size if drop_last else -(-n // batch_size)
    if not drop_last:
        perm = np.resize(perm, n_steps * batch_size)
    return perm[: n_steps * batch_size].reshape(n_steps, batch_size).astype(np.int32)


def metrics_mean(ms: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Mean of each per-step metric: the epoch's one device-to-host fetch."""
    return {k: float(np.mean(v.float().cpu().numpy())) for k, v in ms.items()}
