"""LV-ViT (counterpart: ``fewshot_vit_tpu/models/lvvit.py``).

A residual 3-conv stem at 96 hidden channels (LeakyReLU 0.1, 2x2 max-pool)
and a 4x4/s4 projection, stride 16 in all; a cls token and an (N + 1)-token
positional embedding; pre-LN blocks (eps 1e-5) with qkv WITHOUT bias, MLP
ratio 3 and residual branches divided by ``skip_lam`` = 2; forward: NHWC
(B, H, W, 3) -> (the 5x5 patch map, the cls token). State-dict keys are the
reference's (``patch_embed.conv1``, ``patch_embed.downsample.1``,
``patch_embed.proj``, ``blocks.0.attn.qkv``), the keys
``checkpoint/from_flax.py::lvvit_key`` gives.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.registry import models
from .common import BatchNorm2d, Conv, leaky_relu, max_pool
from .deit import TokenViT


class LVViTStem(nn.Module):
    def __init__(self, hidden: int, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = lambda cin, s: Conv(cin, hidden, 3, s, 1, dtype=dtype, init="trunc")
        self.conv1, self.bn1 = conv(3, 2), BatchNorm2d(hidden, dtype)
        self.conv2, self.bn2 = conv(hidden, 1), BatchNorm2d(hidden, dtype)
        self.conv3, self.bn3 = conv(hidden, 1), BatchNorm2d(hidden, dtype)
        self.downsample = nn.Sequential(conv(3, 2), BatchNorm2d(hidden, dtype))
        self.proj = Conv(hidden, embed_dim, 4, 4, 0, bias=True, dtype=dtype, init="lecun")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = leaky_relu(self.bn1(self.conv1(x)))
        out = leaky_relu(self.bn2(self.conv2(out)))
        out = leaky_relu(self.bn3(self.conv3(out)) + self.downsample(x))
        return self.proj(max_pool(out, 2, 2))


class LVViT(TokenViT):
    """``forward -> (patch map, cls)``; ``dtype`` is the compute dtype,
    parameters stay fp32, weights drawn on the CPU from ``seed``."""

    def __init__(self, img_size: int = 80, embed_dim: int = 384, depth: int = 8,
                 num_heads: int = 6, mlp_ratio: float = 3.0, skip_lam: float = 2.0,
                 stem_hidden: int = 96, drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.5, dtype: torch.dtype = torch.float32,
                 device: Any = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.out_dim = embed_dim
        self.patch_embed = LVViTStem(stem_hidden, embed_dim, dtype)
        g = img_size // 16
        self._build_tokens(g * g, embed_dim, depth, num_heads, mlp_ratio, False, drop_rate,
                           attn_drop_rate, drop_path_rate, 1e-5, skip_lam, dtype)
        self._init(seed, device)


models.register("lvvit_micro_80")(
    lambda **kw: LVViT(**{"img_size": 80, "embed_dim": 384, "depth": 8, "num_heads": 6,
                          "mlp_ratio": 3.0, "skip_lam": 2.0, "drop_path_rate": 0.5, **kw}))
