"""SUN-D (DeepEMD) episode programs (counterpart:
``fewshot_vit_tpu/train/meta_tune_emd.py``).

Only what the eval needs is ported: the eval patch pipelines and the episode
function with ``train=False``. Meta-tuning itself comes with the training
slice.

Episode index order is the reference's INTERLEAVED layout: index t*way + w
is class w, item t; query labels are ``tile(arange(way), query)``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..core.rng import DEFAULT_SEED
from ..data.patches import grid_patches
from ..data.transforms import normalize
from ..heads.deepemd import sfc_refine

_TRAINING_SLICE = "comes with the training slice (ROADMAP.md section 1, slice 3)"


def make_patch_fn(mode: str, patch_list, patch_ratio: float, out_size: int,
                  train: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """images uint8 (B, H, W, 3) -> model input (B[, P], out, out, 3) float
    in [0, 255]: ``grid`` at the fixed eval ``patch_ratio``, or ``fcn``."""
    if mode == "grid":
        if train:
            raise NotImplementedError(f"train-time grid ratios {_TRAINING_SLICE}")
        patch_list = tuple(int(g) for g in patch_list)
        return lambda images: grid_patches(images, patch_list, float(patch_ratio), out_size)
    if mode == "fcn":
        return lambda images: images.to(torch.float32)
    if mode == "sampling":
        raise NotImplementedError(f"'sampling' patches (random resized crops) {_TRAINING_SLICE}")
    raise ValueError(mode)


def episode_logits(head, nodes: torch.Tensor, way: int, shot: int, sfc: bool,
                   sfc_kw: dict, episode_ids: Sequence[int], seed: int) -> torch.Tensor:
    """nodes (E, way*(shot+query), N, C) in the interleaved layout -> logits
    (E, way*query, way): shot-mean prototypes, SFC-refined for shot > 1,
    then EMD matching. Shared by the direct and the cached eval."""
    k = way * shot
    e = nodes.shape[0]
    proto = nodes[:, :k].reshape(e, shot, way, *nodes.shape[2:]).mean(dim=1)
    if sfc and shot > 1:
        proto = sfc_refine(proto, nodes[:, :k], way, shot, episode_ids=episode_ids,
                           seed=seed, **sfc_kw)
    return head.meta(proto, nodes[:, k:])


def make_emd_episode_fn(head, way: int, shot: int, query: int, patch_fn: Callable,
                        mean, std, sfc: bool, sfc_kw: Optional[dict] = None,
                        train: bool = False, seed: int = DEFAULT_SEED) -> Callable:
    """(images uint8 (E, way*(shot+query), H, W, 3), episode_ids (E,)) ->
    logits (E, way*query, way), re-encoding every image of the episodes.

    ``episode_ids`` are global episode indices: they seed the SFC shuffles,
    so an episode's logits do not depend on the batch it runs in."""
    if train:
        raise NotImplementedError(f"SUN-D meta-tuning episodes {_TRAINING_SLICE}")
    sfc_kw = dict(sfc_kw or {})

    def fn(images_u8: torch.Tensor, episode_ids: Sequence[int]) -> torch.Tensor:
        e, n = images_u8.shape[:2]
        x = normalize(patch_fn(images_u8.reshape(e * n, *images_u8.shape[2:])), mean, std)
        nodes = head.encode_nodes(x)
        return episode_logits(head, nodes.reshape(e, n, *nodes.shape[1:]), way, shot,
                              sfc, sfc_kw, episode_ids, seed)

    return fn
