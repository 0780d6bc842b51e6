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

from ..ops.episodes import split_shot_query
from . import steps as steps_mod
from .state import TrainState


def stack_metrics(per_step: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """A list of per-step metric dicts -> one dict of (S,) device tensors."""
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


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
