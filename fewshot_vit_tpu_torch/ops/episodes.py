"""Episode reshaping (counterpart: ``fewshot_vit_tpu/ops/episodes.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


def split_shot_query(
    data: torch.Tensor, way: int, shot: int, query: int, ep_per_batch: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat batch (E*way*(shot+query), ...img) -> shot (E,way,shot,...), query (E,way*query,...).

    Index order is the sampler's: episode-major, class-major, item-minor;
    queries are flattened way-major, matching ``make_nk_label``.
    """
    img_shape = data.shape[1:]
    data = data.reshape(ep_per_batch, way, shot + query, *img_shape)
    x_shot = data[:, :, :shot]
    x_query = data[:, :, shot:].reshape(ep_per_batch, way * query, *img_shape)
    return x_shot, x_query


def make_nk_label(n: int, k: int, ep_per_batch: int = 1, device=None) -> torch.Tensor:
    """Query labels (E, n*k): class index repeated k times per class."""
    label = torch.arange(n, device=device).repeat_interleave(k)
    return label[None, :].expand(ep_per_batch, -1)
