"""Episodic N-way K-shot evaluation (counterpart: ``fewshot_vit_tpu/eval/episodic.py``).

  * the dataset is uploaded to the device once, as uint8; each episode batch
    is a device-side gather by index, then ``normalize``;
  * episode indices are sampled on the host with the JAX package's sampler
    and generator, so the same seed gives the same episodes;
  * per-episode accuracies stay on the device until one host fetch at the end;
  * cached-features mode encodes every image once; episodes are then gathers
    plus cosine logits over the features (identical accuracy for a
    deterministic encoder).

Reports mean accuracy with a 95% Student-t confidence interval.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.device import resolve_device
from ..data.datasets import ArrayDataset
from ..data.sampler import EpisodeSampler
from ..data.staging import upload_images
from ..data.transforms import normalize
from ..ops.episodes import make_nk_label, split_shot_query
from ..ops.metric import compute_logits, mean_confidence_interval, per_episode_acc


def sample_episode_indices(
    dataset: ArrayDataset,
    n_episodes: int,
    way: int,
    n_per: int,
    ep_per_batch: int,
    seed: int,
) -> np.ndarray:
    """(n_batches, ep_per_batch*way*n_per) int32 episode indices (host-side)."""
    n_batches = math.ceil(n_episodes / ep_per_batch)
    sampler = EpisodeSampler(dataset.labels, n_batches, way, n_per, ep_per_batch)
    rng = rng_mod.np_rng(seed)
    return np.stack(list(sampler.epoch(rng))).astype(np.int32)


def _on_device(module: torch.nn.Module, dev: torch.device) -> None:
    have = next(module.parameters()).device
    if have != dev:
        raise ValueError(f"the model is on {have}, the evaluation on {dev}")


def _upload(dataset: ArrayDataset, images_dev: Optional[torch.Tensor],
            dev: torch.device) -> torch.Tensor:
    if images_dev is None:
        return upload_images(dataset.images, dev)
    if images_dev.device != dev or images_dev.dtype != torch.uint8:
        raise ValueError(f"images_dev is {images_dev.dtype} on {images_dev.device}, "
                         f"expected uint8 on {dev}")
    return images_dev


@torch.inference_mode()
def evaluate(
    head: torch.nn.Module,
    dataset: ArrayDataset,
    n_episodes: int = 2000,
    way: int = 5,
    shot: int = 1,
    query: int = 15,
    ep_per_batch: int = 8,
    seed: int = rng_mod.DEFAULT_SEED,
    images_dev: Optional[torch.Tensor] = None,
    indices: Optional[np.ndarray] = None,
    device: Any = "cuda",
) -> Tuple[float, float, np.ndarray]:
    """Full-protocol eval (re-encode every episode). Returns (acc, ci95, accs).

    ``head`` must already be on ``device``. Pass ``images_dev`` (the uint8
    ``dataset.images`` on the device) to share one upload across calls.
    ``indices`` overrides episode sampling with an explicit
    ``(n_batches, ep_per_batch*way*(shot+query))`` index matrix.
    """
    dev = resolve_device(device)
    _on_device(head, dev)
    if indices is None:
        indices = sample_episode_indices(
            dataset, n_episodes, way, shot + query, ep_per_batch, seed)
    idx_all = torch.from_numpy(np.asarray(indices, np.int64)).to(dev)
    images_dev = _upload(dataset, images_dev, dev)
    labels = make_nk_label(way, query, ep_per_batch, device=dev)
    accs = []
    for idx in idx_all:
        x = normalize(images_dev[idx], dataset.mean, dataset.std)
        xs, xq = split_shot_query(x, way, shot, query, ep_per_batch)
        accs.append(per_episode_acc(head(xs, xq), labels))
    accs = torch.cat(accs).cpu().numpy()[:n_episodes]
    m, h = mean_confidence_interval(accs)
    return m, h, accs


@torch.inference_mode()
def encode_dataset(
    encoder: torch.nn.Module,
    dataset: ArrayDataset,
    batch_size: int = 1024,
    images_dev: Optional[torch.Tensor] = None,
    device: Any = "cuda",
) -> torch.Tensor:
    """Embed every image once -> pooled features (N, C), on the device."""
    dev = resolve_device(device)
    _on_device(encoder, dev)
    images_dev = _upload(dataset, images_dev, dev)
    feats = []
    for start in range(0, len(images_dev), batch_size):
        x = normalize(images_dev[start: start + batch_size], dataset.mean, dataset.std)
        feats.append(encoder(x)[1])
    return torch.cat(feats)


@torch.inference_mode()
def evaluate_cached(
    encoder: torch.nn.Module,
    dataset: ArrayDataset,
    n_episodes: int = 2000,
    way: int = 5,
    shot: int = 1,
    query: int = 15,
    ep_per_batch: int = 8,
    temp: float = 10.0,
    seed: int = rng_mod.DEFAULT_SEED,
    feats: Optional[torch.Tensor] = None,
    device: Any = "cuda",
) -> Tuple[float, float, np.ndarray]:
    """Cached-features eval for cosine / meta-baseline heads: the same
    episodes and math as ``evaluate`` over once-encoded features."""
    dev = resolve_device(device)
    if feats is None:
        feats = encode_dataset(encoder, dataset, device=dev)
    idx_all = sample_episode_indices(
        dataset, n_episodes, way, shot + query, ep_per_batch, seed)
    idx_all = torch.from_numpy(idx_all.astype(np.int64)).to(dev)
    labels = make_nk_label(way, query, ep_per_batch, device=dev)
    accs = []
    for idx in idx_all.reshape(-1, ep_per_batch, way, shot + query):
        f = feats[idx]  # (E, way, shot+query, C)
        proto = f[:, :, :shot].mean(dim=2)
        f_query = f[:, :, shot:].reshape(ep_per_batch, way * query, -1)
        logits = compute_logits(f_query, proto, metric="cos", temp=temp)
        accs.append(per_episode_acc(logits, labels))
    accs = torch.cat(accs).cpu().numpy()[:n_episodes]
    m, h = mean_confidence_interval(accs)
    return m, h, accs
