"""Staging for train splits larger than the card's budget (counterpart:
``fewshot_vit_tpu/data/staging.py``).

The epoch programs gather batches from a device-resident uint8 image array.
When the split does not fit the budget:

  * an episodic epoch still touches only ``train_batches * ep_per_batch *
    way * (shot + query)`` images, so the trainer gathers that subset on the
    host (memmap-friendly) and uploads it as one fixed-shape array, with the
    episode indices remapped into it (``epoch_subset``);
  * a whole-classification epoch streams the split through the card in
    equal chunks (``EpochStager``): one permutation per epoch, cut into
    chunks, each chunk's images uploaded as one transfer and scanned with
    chunk-local indices; the permutation is padded by cycling to fill the
    last chunk.

``memmap_cache`` (ImageNet-800 scale) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import numpy as np
import torch

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


class EpochStager:
    """Streams ``(images_dev, labels_dev, idx)`` chunks of one epoch to
    ``device``. Every chunk holds ``chunk_steps * batch_size`` images and
    comes with the same chunk-local (chunk_steps, batch_size) index matrix;
    the permutation and chunking are the JAX package's, from the same
    generator."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int,
                 budget_gb: float = DEFAULT_GPU_BUDGET_GB, device="cuda"):
        self.images = images
        self.labels = np.asarray(labels, np.int32)
        self.batch_size = int(batch_size)
        self.device = device
        n = len(images)
        total_steps = n // self.batch_size
        if total_steps == 0:
            raise ValueError(f"dataset ({n}) smaller than batch size ({batch_size})")
        bytes_per_img = images.nbytes // n
        max_imgs = max(self.batch_size, int(budget_gb * (1 << 30)) // max(bytes_per_img, 1))
        max_steps_per_chunk = max(1, max_imgs // self.batch_size)
        self.n_chunks = math.ceil(total_steps / max_steps_per_chunk)
        self.chunk_steps = math.ceil(total_steps / self.n_chunks)
        self.total_steps = total_steps

    @property
    def chunk_imgs(self) -> int:
        return self.chunk_steps * self.batch_size

    def epoch(self, rng: np.random.Generator
              ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Yield ``(images_dev, labels_dev, idx)`` per chunk. The generator
        drops its references to a chunk before it stages the next; a caller
        that drops its own too never holds two chunks on the card."""
        n = len(self.images)
        perm = rng.permutation(n)
        need = self.n_chunks * self.chunk_imgs
        if need > n:
            perm = np.concatenate([perm, perm[: need - n]])
        perm = perm[:need]
        local_idx = torch.arange(self.chunk_imgs, device=self.device).reshape(
            self.chunk_steps, self.batch_size)
        for c in range(self.n_chunks):
            sel = perm[c * self.chunk_imgs: (c + 1) * self.chunk_imgs]
            # host gather (memmap-friendly: sorted access, then un-sort)
            order = np.argsort(sel, kind="stable")
            gathered = self.images[sel[order]]
            unsort = np.empty_like(order)
            unsort[order] = np.arange(len(order))
            images_dev = torch.from_numpy(np.ascontiguousarray(gathered[unsort])).to(self.device)
            labels_dev = torch.from_numpy(self.labels[sel]).to(self.device)
            yield images_dev, labels_dev, local_idx
            del images_dev, labels_dev
