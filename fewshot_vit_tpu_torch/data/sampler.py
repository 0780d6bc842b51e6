"""Episodic index sampling, host side (counterpart: ``fewshot_vit_tpu/data/sampler.py``).

A copy of the JAX package's sampler: the episode indices must match it
exactly from the same generator. Per batch, for each of ``ep_per_batch``
episodes, draw ``n_way`` classes without replacement, then ``n_per`` items
per class without replacement (score with iid uniforms, keep the k smallest
by ``argpartition``); emit a flat index array in episode-major, class-major,
item-minor order.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class EpisodeSampler:
    def __init__(
        self,
        labels: Sequence[int],
        n_batch: int,
        n_way: int,
        n_per: int,
        ep_per_batch: int = 1,
    ):
        self.n_batch = n_batch
        self.n_way = n_way
        self.n_per = n_per
        self.ep_per_batch = ep_per_batch
        labels = np.asarray(labels)
        self.catlocs: List[np.ndarray] = [
            np.argwhere(labels == c).reshape(-1) for c in range(int(labels.max()) + 1)
        ]
        n_classes = len(self.catlocs)
        if n_way > n_classes:
            raise ValueError(f"n_way={n_way} > {n_classes} classes")
        for c, locs in enumerate(self.catlocs):
            if len(locs) < n_per:
                raise ValueError(f"class {c} has {len(locs)} < n_per={n_per} items")
        # dense (C, Lmax) class->items matrix; padded slots are never selected
        # because their scores are forced to +inf in batch()
        self._cat_len = np.array([len(l) for l in self.catlocs])
        lmax = int(self._cat_len.max())
        self._cat_mat = np.zeros((n_classes, lmax), np.int64)
        for c, locs in enumerate(self.catlocs):
            self._cat_mat[c, : len(locs)] = locs

    def batch(self, rng: np.random.Generator) -> np.ndarray:
        """One flat index batch, shape (ep_per_batch * n_way * n_per,)."""
        e, w, p = self.ep_per_batch, self.n_way, self.n_per
        n_classes, lmax = self._cat_mat.shape
        classes = np.argpartition(
            rng.random((e, n_classes), dtype=np.float32), w - 1, axis=1
        )[:, :w]  # (E, W)
        scores = rng.random((e, w, lmax), dtype=np.float32)
        valid = np.arange(lmax) < self._cat_len[classes][..., None]  # (E, W, Lmax)
        scores = np.where(valid, scores, np.inf)
        item_slots = np.argpartition(scores, p - 1, axis=-1)[..., :p]  # (E, W, P)
        eps = np.take_along_axis(self._cat_mat[classes], item_slots, axis=-1)
        return eps.reshape(-1)

    def epoch(self, rng: np.random.Generator) -> Iterator[np.ndarray]:
        for _ in range(self.n_batch):
            yield self.batch(rng)
