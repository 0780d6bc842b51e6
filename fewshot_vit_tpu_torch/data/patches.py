"""SUN-D patch pipelines (counterpart: ``fewshot_vit_tpu/data/patches.py``).

``grid``: for each g in ``patch_list`` (default (2, 3)), g*g cells of the
image enlarged by ``ratio`` around their centers, each resized bilinearly to
``out_size`` -> 4 + 9 = 13 patches per image. Only the eval path's fixed
scalar ratio is ported: every image then has the same boxes, so each cell is
a fixed pair of (out, in) interpolation matrices, the ones JAX's
``jax.image.scale_and_translate`` builds, and the whole grid is one einsum
per image axis over the batch.

Train-time per-image ratios (``draw_grid_ratios``) and ``sampling`` mode
(random resized crops from JAX's PRNG stream) come with the training slice.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

_TRAINING_SLICE = ("is train-time SUN-D; it comes with the training slice "
                   "(ROADMAP.md section 1, slice 3)")


def draw_grid_ratios(*_args, **_kw):
    raise NotImplementedError(f"draw_grid_ratios {_TRAINING_SLICE}")


def sampling_patches(*_args, **_kw):
    raise NotImplementedError(f"sampling_patches {_TRAINING_SLICE}")


def _grid_boxes_exact(size: int, num_grid: int, ratio: float) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's integer ``get_grid_location`` arithmetic for a static
    ratio: raw cell int(size/g), enlarged int(size/g*ratio), centers at
    raw//2 + raw*i, box (max(0, c - enlarged//2), min(size, c + enlarged//2)).
    Returns float32 (lo, hi), each (g,)."""
    raw = int(size / num_grid)
    enlarged = int(size / num_grid * ratio)
    half = enlarged // 2
    centers = raw // 2 + raw * np.arange(num_grid)
    lo = np.maximum(0, centers - half).astype(np.float32)
    hi = np.minimum(size, centers + half).astype(np.float32)
    return lo, hi


def _bilinear_weight_mat(in_size: int, out_size: int, scale: np.float32,
                         translation: np.float32) -> np.ndarray:
    """(in, out) float32 interpolation matrix of ``scale_and_translate`` with
    the triangle kernel and antialiasing on, as ``compute_weight_mat`` of
    ``jax/_src/image/scale.py`` computes it in float32: kernel widened by
    1/scale when downsampling, columns normalized by their total weight where
    it exceeds 1000 eps, and zeroed where the sample falls outside
    [-0.5, in - 0.5]."""
    f32 = np.float32
    inv_scale = f32(1.0) / scale
    kernel_scale = np.maximum(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - translation * inv_scale - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size) - f32(0.5))
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=16)
def _grid_mats(h: int, w: int, patch_list: Tuple[int, ...], ratio: float,
               out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(P, out, H) row and (P, out, W) column interpolation matrices, one pair
    per grid cell in the JAX order (levels, then cell row i, then cell
    column j)."""
    rows, cols = [], []
    for g in patch_list:
        ly, hy = _grid_boxes_exact(h, g, ratio)
        lx, hx = _grid_boxes_exact(w, g, ratio)
        for i in range(g):
            for j in range(g):
                sy = np.float32(out_size) / (hy[i] - ly[i])
                sx = np.float32(out_size) / (hx[j] - lx[j])
                rows.append(_bilinear_weight_mat(h, out_size, sy, -ly[i] * sy).T)
                cols.append(_bilinear_weight_mat(w, out_size, sx, -lx[j] * sx).T)
    return np.stack(rows), np.stack(cols)


def grid_patches(
    images: torch.Tensor,
    patch_list: Sequence[int] = (2, 3),
    ratio: float = 2.0,
    out_size: int = 80,
) -> torch.Tensor:
    """(B, H, W, 3) uint8/float -> (B, sum(g^2), out, out, 3) float32 in
    [0, 255], for a static scalar ``ratio`` (the eval path's ``patch_ratio``)."""
    if isinstance(ratio, torch.Tensor) or not isinstance(ratio, (int, float)):
        raise NotImplementedError(f"a per-image grid ratio {_TRAINING_SLICE}")
    _, h, w = images.shape[:3]
    wy, wx = _grid_mats(h, w, tuple(int(g) for g in patch_list), float(ratio), out_size)
    wy = torch.from_numpy(wy).to(images.device)
    wx = torch.from_numpy(wx).to(images.device)
    rows = torch.einsum("pyh,bhwc->bpywc", wy, images.to(torch.float32))
    return torch.einsum("pxw,bpywc->bpyxc", wx, rows)
