"""Device-side augmentation (counterpart: ``fewshot_vit_tpu/data/augment.py``).
Only ``random_resized_crop`` is ported so far (SUN-D ``sampling`` patches);
the rest of the augmentation zoo comes with the pretrain slice."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .patches import resample_boxes


def random_resized_crop(
    generator: Optional[torch.Generator],
    images: torch.Tensor,
    out_size: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """torchvision RandomResizedCrop semantics, batched, bilinear resample:
    (B, H, W, 3) -> float32 (B, out, out, 3) in [0, 255].

    Four U[0, 1) draws per image, from ``generator`` or from ``uniforms``
    (4, B): the area as a share of the image in ``scale``, the log-uniform
    aspect in ``ratio``, and the box's x and y offsets. A box that does not
    fit is clamped to the image."""
    b, h, w = images.shape[:3]
    if uniforms is None:
        uniforms = torch.rand(4, b, generator=generator, device=images.device)
    u1, u2, u3, u4 = uniforms.to(images.device, torch.float32)
    area = h * w * (scale[0] + u1 * (scale[1] - scale[0]))
    log_lo, log_hi = math.log(ratio[0]), math.log(ratio[1])
    r = torch.exp(log_lo + u2 * (log_hi - log_lo))
    cw = torch.clamp(torch.sqrt(area * r), 1.0, float(w))
    ch = torch.clamp(torch.sqrt(area / r), 1.0, float(h))
    x0 = u3 * (w - cw)
    y0 = u4 * (h - ch)
    return resample_boxes(images, y0, y0 + ch, x0, x0 + cw, out_size)
