"""ConvNet-4 (counterpart: ``fewshot_vit_tpu/models/convnet4.py``).

Four blocks of a biased 3x3 conv, BN, ReLU and a 2x2 max-pool, 64 channels;
forward: NHWC (B, H, W, 3) -> (the dense NHWC map, its flattening in NCHW
order, the reference's 1600-d feature at 80 px). State-dict keys are the
reference's (``encoder.0.0`` conv, ``encoder.0.1`` BN), the keys
``checkpoint/from_flax.py::convnet4_key`` gives.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.registry import models
from .common import BatchNorm2d, Conv, init_weights, max_pool


class ConvNet4(nn.Module):
    """``dtype`` is the compute dtype, parameters stay fp32, convs drawn as
    flax's default (LeCun normal) on the CPU from ``seed``; ``img_size`` is
    accepted and unused (``out_dim`` assumes 80 px, as the reference)."""

    def __init__(self, hid_dim: int = 64, z_dim: int = 64, img_size: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device: Any = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.out_dim = z_dim * 25
        dims = [3, hid_dim, hid_dim, hid_dim, z_dim]
        self.encoder = nn.ModuleList(
            nn.Sequential(Conv(dims[i], dims[i + 1], 3, 1, 1, bias=True, dtype=dtype,
                               init="lecun"), BatchNorm2d(dims[i + 1], dtype))
            for i in range(4))
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device).eval()

    def forward(self, x: torch.Tensor):
        for block in self.encoder:
            x = max_pool(torch.relu(block(x)), 2, 2)
        return x, x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


models.register("convnet4")(lambda **kw: ConvNet4(**kw))
