"""SUN-D (DeepEMD) episodic evaluation (counterpart:
``fewshot_vit_tpu/eval/emd_eval.py``, with the protocol of
``fewshot_vit_tpu/eval/run_emd.py``).

Two strategies over the same episode math:

* direct: ``train.meta_tune_emd.make_emd_episode_fn`` re-encodes the
  episode's images (the reference's work per episode);
* cached: for the deterministic eval pipelines (grid at a fixed
  ``patch_ratio``, fcn) an image's nodes are a fixed function of the image,
  so ``make_emd_node_cache_fn`` encodes each image once and
  ``make_emd_cached_episode_fn`` gathers nodes per episode.

Episodes are drawn on the host with the JAX package's sampler and seed and
reordered into the interleaved layout; per-episode accuracies stay on the
device until one host fetch at the end. The CI is the SUN-D normal interval
(``ops.metric.normal_confidence_interval``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.device import resolve_device
from ..data.datasets import ArrayDataset
from ..data.transforms import normalize
from ..ops.metric import normal_confidence_interval, per_episode_acc
from ..train.meta_tune_emd import episode_logits, make_emd_episode_fn, make_patch_fn
from .episodic import _on_device, _upload, sample_episode_indices


def make_emd_node_cache_fn(head, patch_fn: Callable, mean, std,
                           batch: int = 128) -> Callable[[torch.Tensor], torch.Tensor]:
    """images uint8 (N, H, W, 3) -> node features (N, Nn, C), every image
    encoded once through the deterministic eval patch pipeline."""

    def encode_all(images: torch.Tensor) -> torch.Tensor:
        nodes = [head.encode_nodes(normalize(patch_fn(images[s: s + batch]), mean, std))
                 for s in range(0, images.shape[0], batch)]
        return torch.cat(nodes)

    return encode_all


def make_emd_cached_episode_fn(head, way: int, shot: int, sfc: bool,
                               sfc_kw: Optional[dict] = None,
                               seed: int = rng_mod.DEFAULT_SEED) -> Callable:
    """(ep_nodes (E, way*(shot+query), Nn, C), episode_ids (E,)) -> logits:
    the cached twin of ``make_emd_episode_fn``, minus the encoder."""
    sfc_kw = dict(sfc_kw or {})

    def fn(ep_nodes: torch.Tensor, episode_ids: Sequence[int]) -> torch.Tensor:
        return episode_logits(head, ep_nodes, way, shot, sfc, sfc_kw, episode_ids, seed)

    return fn


def make_emd_eval_run_fn(episode_fn: Callable, labels: torch.Tensor) -> Callable:
    """``(data, idx (n_batches, epb, ep_len)) -> accs (n_batches*epb,)`` on the
    device. Episode ``b*epb + e`` gets global index ``b*epb + e``, so the
    accuracies do not depend on the grouping."""

    def run(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        epb = idx.shape[1]
        lab = labels[None].expand(epb, -1)
        accs = [per_episode_acc(episode_fn(data[idx_b], range(b * epb, (b + 1) * epb)), lab)
                for b, idx_b in enumerate(idx)]
        return torch.cat(accs)

    return run


def group_episode_indices(idx, ep_per_batch: int) -> np.ndarray:
    """(n_episodes, ep_len) -> (n_batches, epb, ep_len) int32, padding by
    repeating the last episode (truncate accs to n_episodes after the run)."""
    idx = np.asarray(idx, np.int32)
    n_pad = (-idx.shape[0]) % ep_per_batch
    if n_pad:
        idx = np.concatenate([idx, np.repeat(idx[-1:], n_pad, axis=0)])
    return idx.reshape(-1, ep_per_batch, idx.shape[-1])


def sample_emd_episode_indices(dataset: ArrayDataset, n_episodes: int, way: int,
                               n_per: int, seed: int = rng_mod.DEFAULT_SEED) -> np.ndarray:
    """(n_episodes, way*n_per) int32 episode indices in the interleaved
    layout, one sampler batch per episode, as the JAX SUN-D eval draws them."""
    idx = sample_episode_indices(dataset, n_episodes, way, n_per, 1, seed)
    return idx.reshape(n_episodes, way, n_per).transpose(0, 2, 1).reshape(n_episodes, -1)


@torch.no_grad()
def evaluate_emd(
    head: torch.nn.Module,
    dataset: ArrayDataset,
    way: int = 5,
    shot: int = 1,
    query: int = 15,
    n_episodes: int = 2000,
    ep_per_batch: int = 4,
    mode: str = "grid",
    cached: bool = False,
    indices: Optional[np.ndarray] = None,
    patch_list: Sequence[int] = (2, 3),
    patch_ratio: float = 2.0,
    image_size: int = 80,
    num_patch: int = 9,
    sfc_kw: Optional[dict] = None,
    images_dev: Optional[torch.Tensor] = None,
    seed: int = rng_mod.DEFAULT_SEED,
    device: Any = "cuda",
) -> Tuple[float, float, np.ndarray]:
    """SUN-D episodic eval of a ``DeepEMD`` head -> (acc, ci95, accs).

    ``head`` must already be on ``device``. ``indices`` overrides sampling
    with explicit interleaved ``(n_episodes, way*(shot+query))`` indices.
    ``images_dev`` is ``dataset.images`` already on the device (uint8).
    SFC (shot > 1) takes ``sfc_kw`` (``steps``, ``lr``, ``batch_size``) and
    runs with autograd inside this ``no_grad`` eval. ``mode='sampling'``
    (``num_patch`` random resized crops per image) draws each episode batch's
    crops from a generator seeded by (``seed``, its first global episode
    index); its patches are random, so it cannot be ``cached``."""
    dev = resolve_device(device)
    _on_device(head, dev)
    if indices is None:
        indices = sample_emd_episode_indices(dataset, n_episodes, way, shot + query, seed)
    n_episodes = len(indices)
    idx = torch.from_numpy(group_episode_indices(indices, max(1, ep_per_batch))
                           .astype(np.int64)).to(dev)
    images_dev = _upload(dataset, images_dev, dev)
    patch_fn = make_patch_fn(mode, patch_list, patch_ratio, image_size, train=False,
                             num_patch=num_patch)
    sfc = shot > 1
    if cached and mode == "sampling":
        raise ValueError("'sampling' patches are random per episode: they cannot be cached")
    if cached:
        data = make_emd_node_cache_fn(head, patch_fn, dataset.mean, dataset.std)(images_dev)
        ep_fn = make_emd_cached_episode_fn(head, way, shot, sfc, sfc_kw, seed)
    else:
        data = images_dev
        ep_fn = make_emd_episode_fn(head, way, shot, query, patch_fn, dataset.mean,
                                    dataset.std, sfc, sfc_kw, seed=seed)
    labels = torch.arange(way, device=dev).repeat(query)
    accs = make_emd_eval_run_fn(ep_fn, labels)(data, idx).cpu().numpy()[:n_episodes]
    m, h = normal_confidence_interval(accs)
    return m, h, accs
