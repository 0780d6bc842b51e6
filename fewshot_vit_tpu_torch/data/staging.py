"""Epoch-subset staging for train splits larger than the card's budget
(counterpart: ``fewshot_vit_tpu/data/staging.py``).

The epoch programs gather batches from a device-resident uint8 image array.
When the split does not fit the budget, an episodic epoch still touches only
``train_batches * ep_per_batch * way * (shot + query)`` images, so the
trainer gathers that subset on the host (memmap-friendly) and uploads it as
one fixed-shape array, with the episode indices remapped into it.
``EpochStager`` (chunked streaming for pretraining) and ``memmap_cache``
come with the pretrain slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

DEFAULT_GPU_BUDGET_GB = 8.0


def needs_staging(images: np.ndarray, budget_gb: float = DEFAULT_GPU_BUDGET_GB) -> bool:
    return images.nbytes > budget_gb * (1 << 30)


def gpu_budget_gb(cfg) -> float:
    """``gpu_budget_gb`` of a config; the JAX package's key ``hbm_budget_gb``
    is accepted as its alias."""
    return float(cfg.get("gpu_budget_gb", cfg.get("hbm_budget_gb", DEFAULT_GPU_BUDGET_GB)))


def epoch_subset(images: np.ndarray, idx: np.ndarray, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gather the unique images an epoch's episode indices touch, padded to a
    fixed ``cap`` rows, and remap ``idx`` into the subset."""
    uniq, inv = np.unique(idx, return_inverse=True)
    if len(uniq) > cap:
        raise ValueError(f"epoch touches {len(uniq)} unique images > cap {cap}")
    subset = np.asarray(images[uniq])
    if len(uniq) < cap:
        pad = np.broadcast_to(subset[:1], (cap - len(uniq),) + subset.shape[1:])
        subset = np.concatenate([subset, pad])
    return subset, inv.reshape(idx.shape).astype(np.int32)
