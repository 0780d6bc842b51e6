"""Plain PyTorch episode heads and input transforms.

  * ``normalize``: uint8 NHWC -> (x / 255 - mean) / std;
  * ``cosine_logits``: Meta-Baseline (Chen et al., ICCV 2021): shot-mean
    prototypes, cosine similarity times the temperature;
  * ``grid_patches``: DeepEMD's grid (Zhang et al., CVPR 2020, as SUN-D runs
    it): for each g in the patch list, g x g cells of the image enlarged by
    ``ratio`` about their centres, each resampled to ``out`` px with a
    triangle (bilinear, antialiased) kernel over the whole image;
  * ``emd_logits``: DeepEMD's matching: cross-reference node weights,
    centred cosine similarity, entropic OT (log-domain Sinkhorn, a fixed
    number of iterations) over cost 1 - similarity (``emd_flow``), logits =
    sum(sim * flow) * temperature / nodes, in float64.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def normalize(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.as_tensor(np.asarray(mean), dtype=torch.float32, device=images_u8.device)
    s = torch.as_tensor(np.asarray(std), dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() / 255.0 - m) / s


def cosine_logits(query: torch.Tensor, proto: torch.Tensor, temp: float) -> torch.Tensor:
    """query (E, Q, C), proto (E, way, C) -> (E, Q, way)."""
    return torch.einsum("eqc,ewc->eqw", F.normalize(query, dim=-1),
                        F.normalize(proto, dim=-1)) * temp


def _triangle_weights(in_size: int, out_size: int, lo: float, hi: float) -> torch.Tensor:
    """(out, in) float64 weights that resample the span [lo, hi) of an axis
    of ``in_size`` pixels onto ``out_size`` pixels: output pixel centre i maps
    to input coordinate lo + (i + 0.5) * (hi - lo) / out - 0.5, a triangle
    kernel widened by the span's shrink factor when it shrinks, each row
    normalized to sum 1; an output sample outside the image is 0."""
    step = (hi - lo) / out_size
    width = max(step, 1.0)
    centre = lo + (np.arange(out_size) + 0.5) * step - 0.5
    taps = np.arange(in_size)
    w = np.maximum(0.0, 1.0 - np.abs(centre[:, None] - taps[None, :]) / width)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total > 1000 * np.finfo(np.float32).eps, w / np.where(total > 0, total, 1), 0.0)
    inside = (centre >= -0.5) & (centre <= in_size - 0.5)
    return torch.from_numpy(np.where(inside[:, None], w, 0.0))


def grid_boxes(size: int, g: int, ratio: float):
    """The integer cells: raw cell int(size / g), enlarged int(size / g *
    ratio), centred at raw // 2 + raw * i, clipped to the image."""
    raw = int(size / g)
    half = int(size / g * ratio) // 2
    centres = raw // 2 + raw * np.arange(g)
    return np.maximum(0, centres - half), np.minimum(size, centres + half)


def grid_patches(images: torch.Tensor, patch_list: Sequence[int], ratio: float,
                 out: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, sum g^2, out, out, 3) float32 in [0, 255]; cells
    ordered by level, then row, then column."""
    b, h, w, _ = images.shape
    x = images.double()
    patches = []
    for g in patch_list:
        ly, hy = grid_boxes(h, int(g), ratio)
        lx, hx = grid_boxes(w, int(g), ratio)
        for i in range(int(g)):
            wy = _triangle_weights(h, out, float(ly[i]), float(hy[i])).to(x.device)
            for j in range(int(g)):
                wx = _triangle_weights(w, out, float(lx[j]), float(hx[j])).to(x.device)
                patches.append(torch.einsum("yh,bhwc,xw->byxc", wy, x, wx))
    return torch.stack(patches, dim=1).float()


def sinkhorn(cost: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, reg: float,
             iters: int) -> torch.Tensor:
    """Entropic OT flow in the log domain: potentials from zero, ``iters``
    rounds of a row then a column update."""
    log_k = -cost / reg
    log_w1, log_w2 = torch.log(w1), torch.log(w2)
    f = torch.zeros_like(w1)
    g = torch.zeros_like(w2)
    for _ in range(iters):
        f = log_w1 - torch.logsumexp(log_k + g[..., None, :], dim=-1)
        g = log_w2 - torch.logsumexp(log_k + f[..., :, None], dim=-2)
    return torch.exp(log_k + f[..., :, None] + g[..., None, :])


def _marginal(nodes: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """nodes (..., M, N, C), other (..., K, N, C) -> (..., M, K, N): relu of
    each node's product with the other side's mean node, plus 1e-3, then
    relu + 1e-5 and rescaled to sum to N."""
    w = torch.relu(torch.einsum("...mnc,...kc->...mkn", nodes, other.mean(dim=-2))) + 1e-3
    w = torch.relu(w) + 1e-5
    return w * w.shape[-1] / w.sum(dim=-1, keepdim=True)


def emd_flow(proto: torch.Tensor, query: torch.Tensor, reg: float, iters: int,
             dtype: torch.dtype = torch.float64):
    """proto (E, way, N, C), query (E, Q, N, C) -> (similarity, flow), each
    (E, Q, way, N query nodes, N prototype nodes), computed in ``dtype``."""
    proto, query = proto.to(dtype), query.to(dtype)
    w1 = _marginal(query, proto)                      # (E, Q, way, N)
    w2 = _marginal(proto, query).transpose(-2, -3)    # (E, Q, way, N)
    centre = lambda t: F.normalize(t - t.mean(dim=-1, keepdim=True), dim=-1)
    sim = torch.einsum("eqnc,ewmc->eqwnm", centre(query), centre(proto))
    return sim, sinkhorn(1.0 - sim, w1, w2, reg, iters)


def emd_logits(proto: torch.Tensor, query: torch.Tensor, temperature: float, reg: float,
               iters: int) -> torch.Tensor:
    """proto (E, way, N, C), query (E, Q, N, C) -> logits (E, Q, way), float64."""
    sim, flow = emd_flow(proto, query, reg, iters)
    return (sim * flow).sum(dim=(-1, -2)) * (temperature / sim.shape[-1])
