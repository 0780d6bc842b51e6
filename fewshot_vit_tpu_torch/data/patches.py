"""SUN-D patch pipelines (counterpart: ``fewshot_vit_tpu/data/patches.py``).

``grid``: for each g in ``patch_list`` (default (2, 3)), g*g cells of the
image enlarged by ``ratio`` around their centers, each resized bilinearly to
``out_size`` -> 4 + 9 = 13 patches per image. Every resize is a pair of
(out, in) interpolation matrices, the ones JAX's
``jax.image.scale_and_translate`` builds, applied with one einsum per image
axis.

  * eval: one fixed scalar ``ratio``, so every image has the same boxes and
    the matrices are built once on the host (``_grid_mats``);
  * train: a (B, n_levels) ratio drawn per image and level
    (``draw_grid_ratios``), so the matrices are per image and are built on
    the device as batched tensors (``batched_weight_mat``).

``sampling``: ``num_patch`` independent random resized crops per image.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch


def draw_grid_ratios(generator: Optional[torch.Generator], batch: int, n_levels: int,
                     device=None) -> torch.Tensor:
    """Train-time grid ratios, one iid ``1 + 2 * U[0, 1)`` draw per (image,
    level), float32 (batch, n_levels) on ``device`` (the generator's)."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    return 1.0 + 2.0 * torch.rand(batch, n_levels, generator=generator, device=device)


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


def _grid_boxes(size: int, num_grid: int, ratio: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_grid_boxes_exact`` for a float32 tensor of ratios: the integer
    truncations become ``floor`` in float32 (exact except where
    ``size / g * ratio`` lands within rounding of an integer, a measure-zero
    event for the U[1, 3) draws). Returns (lo, hi) of shape
    ``ratio.shape + (num_grid,)``."""
    raw = int(size / num_grid)
    ratio = ratio.to(torch.float32)
    enlarged = torch.floor(torch.tensor(size / num_grid, dtype=torch.float32,
                                        device=ratio.device) * ratio)
    half = torch.floor(enlarged / 2.0)
    centers = (raw // 2 + raw * torch.arange(num_grid, device=ratio.device)).to(torch.float32)
    lo = torch.clamp(centers - half[..., None], min=0.0)
    hi = torch.clamp(centers + half[..., None], max=float(size))
    return lo, hi


def batched_weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                       translation: torch.Tensor) -> torch.Tensor:
    """``_bilinear_weight_mat`` for float32 tensors ``scale`` and
    ``translation`` of one shape S, on their device: the same formula in
    float32, transposed -> S + (out, in)."""
    scale = scale.to(torch.float32)[..., None, None]
    translation = translation.to(torch.float32)[..., None, None]
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)[:, None]
    sample_f = (out_pos + 0.5) * inv_scale - translation * inv_scale - 0.5  # S + (out, 1)
    x = torch.abs(sample_f - torch.arange(in_size, dtype=torch.float32, device=dev)) / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)                                 # S + (out, in)
    total = weights.sum(dim=-1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, weights, torch.zeros_like(weights))


def resample_boxes(images: torch.Tensor, y0: torch.Tensor, y1: torch.Tensor,
                   x0: torch.Tensor, x1: torch.Tensor, out_size: int) -> torch.Tensor:
    """Resize the box [y0, y1) x [x0, x1) of each image to (out, out)
    bilinearly: images (B, H, W, 3), box coordinates (B,) or (B, P) ->
    float32 (B[, P], out, out, 3). One pair of batched einsums."""
    _, h, w = images.shape[:3]
    sy = out_size / (y1 - y0)
    sx = out_size / (x1 - x0)
    wy = batched_weight_mat(h, out_size, sy, -y0 * sy)
    wx = batched_weight_mat(w, out_size, sx, -x0 * sx)
    x = images.to(torch.float32)
    if y0.dim() == 1:
        return torch.einsum("bxw,bywc->byxc", wx, torch.einsum("byh,bhwc->bywc", wy, x))
    return torch.einsum("bpxw,bpywc->bpyxc", wx, torch.einsum("bpyh,bhwc->bpywc", wy, x))


def grid_patches(
    images: torch.Tensor,
    patch_list: Sequence[int] = (2, 3),
    ratio: Union[float, torch.Tensor] = 2.0,
    out_size: int = 80,
) -> torch.Tensor:
    """(B, H, W, 3) uint8/float -> (B, sum(g^2), out, out, 3) float32 in
    [0, 255]. ``ratio``: a Python scalar (eval: the fixed ``patch_ratio`` for
    every image and level, exact integer boxes) or a (B, len(patch_list))
    tensor (train: ``draw_grid_ratios``), cells ordered levels, then cell
    row, then cell column."""
    b, h, w = images.shape[:3]
    patch_list = tuple(int(g) for g in patch_list)
    if isinstance(ratio, (int, float)):
        wy, wx = _grid_mats(h, w, patch_list, float(ratio), out_size)
        wy = torch.from_numpy(wy).to(images.device)
        wx = torch.from_numpy(wx).to(images.device)
        rows = torch.einsum("pyh,bhwc->bpywc", wy, images.to(torch.float32))
        return torch.einsum("pxw,bpywc->bpyxc", wx, rows)
    ratio = torch.as_tensor(ratio, dtype=torch.float32, device=images.device)
    if ratio.dim() == 0:
        ratio = ratio.expand(b, len(patch_list))
    if tuple(ratio.shape) != (b, len(patch_list)):
        raise ValueError(f"ratio shape {tuple(ratio.shape)} != ({b}, {len(patch_list)}) "
                         "(B, n_levels)")
    y0, y1, x0, x1 = [], [], [], []
    for li, g in enumerate(patch_list):
        lo_y, hi_y = _grid_boxes(h, g, ratio[:, li])  # (B, g)
        lo_x, hi_x = _grid_boxes(w, g, ratio[:, li])
        y0.append(lo_y.repeat_interleave(g, dim=1))   # cell (i, j) at i*g + j
        y1.append(hi_y.repeat_interleave(g, dim=1))
        x0.append(lo_x.repeat(1, g))
        x1.append(hi_x.repeat(1, g))
    return resample_boxes(images, torch.cat(y0, 1), torch.cat(y1, 1), torch.cat(x0, 1),
                          torch.cat(x1, 1), out_size)


def sampling_uniforms(generator: Optional[torch.Generator], num_patch: int, n: int,
                      device) -> torch.Tensor:
    """The (num_patch, 4, n) U[0, 1) draws of ``sampling_patches`` over n images."""
    return torch.rand(num_patch, 4, n, generator=generator, device=device)


def sampling_patches(
    generator: Optional[torch.Generator],
    images: torch.Tensor,
    num_patch: int = 9,
    out_size: int = 80,
    scale: Tuple[float, float] = (0.08, 1.0),
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, W, 3) -> (B, num_patch, out, out, 3): independent random
    resized crops, their draws from ``generator`` or from ``uniforms``
    (num_patch, 4, B)."""
    from .augment import random_resized_crop

    if uniforms is None:
        uniforms = sampling_uniforms(generator, num_patch, images.shape[0], images.device)
    patches = [random_resized_crop(None, images, out_size, scale=scale, uniforms=u)
               for u in uniforms]
    return torch.stack(patches, dim=1)
