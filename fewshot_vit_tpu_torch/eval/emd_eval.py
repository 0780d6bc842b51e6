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
from ..core import trace
from ..core.device import resolve_device
from ..core.rng import torch_generator
from ..data.datasets import ArrayDataset
from ..data.patches import sampling_uniforms
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


def make_emd_eval_run_fn(episode_fn: Callable, labels: torch.Tensor, mesh=None,
                         batch_draws: Optional[Callable] = None) -> Callable:
    """``(data, idx (n_batches, epb, ep_len)) -> accs (n_batches*epb,)`` on the
    device. Episode ``b*epb + e`` gets global index ``b*epb + e``, so the
    accuracies do not depend on the grouping.

    ``mesh``: each rank runs its contiguous block of every batch's episodes
    (their global indices, so SFC's shuffles are those of the whole batch)
    and the accuracies are gathered back in global order on every rank.
    ``batch_draws(first, block) -> kwargs`` gives a batch whose random draws
    belong to the whole batch (``sampling`` crops) the key and this block's
    share of the whole batch's draws."""

    def run(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        epb = idx.shape[1]
        block = mesh.block(epb) if mesh is not None else slice(0, epb)
        lab = labels[None].expand(block.stop - block.start, -1)
        accs = []
        for b, idx_b in enumerate(idx):
            with trace.span("eval.batch"):
                kw = batch_draws(b * epb, block) if batch_draws is not None else {}
                ids = range(b * epb, (b + 1) * epb)[block]
                logits = episode_fn(data[idx_b[block]], ids, **kw)
                with trace.span("eval.accuracy"):
                    accs.append(per_episode_acc(logits, lab))
        accs = torch.stack(accs)  # (n_batches, this rank's episodes)
        if mesh is not None:
            accs = mesh.gather(accs, dim=1)
        return accs.reshape(-1)

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
    mesh=None,
) -> Tuple[float, float, np.ndarray]:
    """SUN-D episodic eval of a ``DeepEMD`` head -> (acc, ci95, accs).

    ``head`` must already be on ``device``. ``indices`` overrides sampling
    with explicit interleaved ``(n_episodes, way*(shot+query))`` indices.
    ``images_dev`` is ``dataset.images`` already on the device (uint8).
    SFC (shot > 1) takes ``sfc_kw`` (``steps``, ``lr``, ``batch_size``) and
    runs with autograd inside this ``no_grad`` eval. ``mode='sampling'``
    (``num_patch`` random resized crops per image) draws each episode batch's
    crops from a generator seeded by (``seed``, its first global episode
    index); its patches are random, so it cannot be ``cached``. ``mesh`` (a
    ``parallel.Mesh``): episode parallelism over its ``data`` axis, which
    must divide ``ep_per_batch``; every rank returns the unsharded result."""
    dev = resolve_device(device)
    _on_device(head, dev)
    if indices is None:
        with trace.span("eval.sample"):
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
    batch_draws = None
    if mesh is not None and mode == "sampling":
        n_img = idx.shape[2]

        def batch_draws(first, block):  # the whole batch's crops, this block's share
            u = sampling_uniforms(torch_generator(dev, seed, first, 1), num_patch,
                                  idx.shape[1] * n_img, dev)
            return {"key": (seed, first),
                    "uniforms": u[..., block.start * n_img:block.stop * n_img]}

    run = make_emd_eval_run_fn(ep_fn, labels, mesh, batch_draws)
    accs = run(data, idx)
    with trace.span("eval.collect"):
        accs = accs.cpu().numpy()[:n_episodes]
        m, h = normal_confidence_interval(accs)
    return m, h, accs
