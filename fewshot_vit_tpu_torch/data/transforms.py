"""Image transforms (counterpart: ``fewshot_vit_tpu/data/transforms.py``).

Host side, once at load: the eval geometry Resize(88,88) -> CenterCrop(80)
or the train-phase Resize(short side), both PIL bicubic. Device side, per
batch: uint8 -> normalized float.
"""

from __future__ import annotations

import numpy as np
import torch

# ImageNet normalization (reference ``datasets/mini_imagenet.py:151-152``)
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(x: torch.Tensor, mean=MEAN, std=STD,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> normalized float, computed in ``dtype``."""
    mean_t = torch.as_tensor(np.asarray(mean), dtype=dtype, device=x.device)
    std_t = torch.as_tensor(np.asarray(std), dtype=dtype, device=x.device)
    x = x.to(dtype) / torch.tensor(255.0, dtype=dtype, device=x.device)
    return (x - mean_t) / std_t


def resize_center_crop(img_np: np.ndarray, resize: int = 88, crop: int = 80) -> np.ndarray:
    """Host-side eval geometry: PIL bicubic Resize((r,r)) + CenterCrop(c)."""
    from PIL import Image

    im = Image.fromarray(img_np).resize((resize, resize), Image.BICUBIC)
    left = (resize - crop) // 2
    return np.asarray(im.crop((left, left, left + crop, left + crop)), np.uint8)


def resize_short(img_np: np.ndarray, size: int = 80) -> np.ndarray:
    """Host-side Resize(size) of the short side, PIL bicubic (the reference's
    train-phase default transform; a square input becomes (size, size))."""
    from PIL import Image

    im = Image.fromarray(img_np)
    w, h = im.size
    if w <= h:
        new = (size, max(1, round(h * size / w)))
    else:
        new = (max(1, round(w * size / h)), size)
    return np.asarray(im.resize(new, Image.BICUBIC), np.uint8)
