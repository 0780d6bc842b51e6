"""ResNet-12 and its DropBlock variant (counterpart:
``fewshot_vit_tpu/models/resnet12.py``).

  * ``resnet12`` (64, 128, 256, 512) and ``resnet12-wide`` (64, 160, 320,
    640): four blocks of three 3x3 conv + BN (LeakyReLU 0.1) with a 1x1 conv
    + BN shortcut, each followed by a 2x2 max-pool; 80x80 -> 5x5. ``fold_bn``
    builds biased convs and no BatchNorm (``models/fold.py::fold_resnet12``);
  * ``resnet12-drop``: wide channels, no pool after the fourth block (a 10x10
    map), dropout after blocks 1-2 and DropBlock(5) after blocks 3-4, whose
    keep rate ramps down over the training batches each block has seen
    (``num_batches_tracked``, counted on training forwards outside
    ``frozen_bn()``);
  * forward: NHWC (B, H, W, 3) -> (dense NHWC, pooled).

State-dict keys are the reference's (``layer1.conv1``, ``layer1.downsample.1``;
``layer1.0.conv1`` and ``layer1.0.num_batches_tracked`` for the drop
variant), the keys ``checkpoint/from_flax.py::resnet_key`` and
``resnet12_drop_key`` give.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..core.registry import models
from .common import (
    BatchNorm2d,
    Conv,
    Dropout,
    Foldable,
    bernoulli,
    bn_uses_running_stats,
    global_avg_pool,
    init_weights,
    leaky_relu,
    max_pool,
)


class Res12Residual(nn.Module):
    """Three 3x3 conv + BN and a 1x1 conv + BN shortcut, LeakyReLU(0.1)."""

    def __init__(self, cin: int, planes: int, fold_bn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = lambda ci, k: Conv(ci, planes, k, 1, k // 2, bias=fold_bn, dtype=dtype)
        bn = lambda: nn.Identity() if fold_bn else BatchNorm2d(planes, dtype)
        self.conv1, self.bn1 = conv(cin, 3), bn()
        self.conv2, self.bn2 = conv(planes, 3), bn()
        self.conv3, self.bn3 = conv(planes, 3), bn()
        self.downsample = nn.Sequential(conv(cin, 1), bn())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = leaky_relu(self.bn1(self.conv1(x)))
        out = leaky_relu(self.bn2(self.conv2(out)))
        return leaky_relu(self.bn3(self.conv3(out)) + self.downsample(x))


class ResNet12(Foldable, nn.Module):
    """``forward -> (dense NHWC, pooled)``; ``dtype`` is the compute dtype,
    parameters stay fp32, convs drawn kaiming-normal (fan out) on the CPU
    from ``seed``; ``img_size`` is accepted and unused."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256, 512), fold_bn: bool = False,
                 img_size: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 device: Any = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = dict(channels=tuple(channels), fold_bn=fold_bn, dtype=dtype)
        self.out_dim = channels[3]
        cin = 3
        for i, c in enumerate(channels):
            setattr(self, f"layer{i + 1}", Res12Residual(cin, c, fold_bn, dtype))
            cin = c
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device).eval()

    def forward(self, x: torch.Tensor):
        for i in range(1, 5):
            x = max_pool(getattr(self, f"layer{i}")(x), 2, 2)
        return x, global_avg_pool(x)


class DropBlock(nn.Module):
    """Zero ``block_size``-square neighbourhoods around Bernoulli(gamma)
    centres and rescale by the kept fraction. The centres' dilation is a
    max-pool over the asymmetric pad ((bs - 1) // 2, bs // 2)."""

    def __init__(self, block_size: int):
        super().__init__()
        self.block_size = block_size

    def forward(self, x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        bs = self.block_size
        b, h, w, c = x.shape
        pts = bernoulli(gamma, (b, h - bs + 1, w - bs + 1, c), x).to(x.dtype)
        lp, rp = (bs - 1) // 2, bs // 2
        pts = F.pad(pts.permute(0, 3, 1, 2), (lp, rp, lp, rp))
        dilated = F.max_pool2d(F.pad(pts, (lp, rp, lp, rp), value=float("-inf")), bs, 1)
        mask = 1.0 - dilated.permute(0, 2, 3, 1)
        return mask * x * (mask.numel() / torch.clamp(mask.sum(), min=1.0))


class Res12DropBlock(Res12Residual):
    """The residual, an optional 2x2 max-pool, then dropout or DropBlock."""

    def __init__(self, cin: int, planes: int, pool: bool = True, drop_rate: float = 0.0,
                 drop_block: bool = False, block_size: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, planes, dtype=dtype)
        self.pool, self.drop_rate, self.drop_block = pool, drop_rate, drop_block
        self.block_size = block_size
        if drop_rate > 0:
            self.register_buffer("num_batches_tracked", torch.zeros(()))
            self.drop = DropBlock(block_size) if drop_block else Dropout(drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = super().forward(x)
        if self.pool:
            out = max_pool(out, 2, 2)
        if self.drop_rate > 0:
            if not bn_uses_running_stats(self.training):
                self.num_batches_tracked += 1.0
            if not self.drop_block:
                return self.drop(out)
            fs, bs = out.shape[1], self.block_size
            keep = torch.clamp(1.0 - self.drop_rate / (20 * 2000) * self.num_batches_tracked,
                               min=1.0 - self.drop_rate)
            gamma = (1.0 - keep) / bs ** 2 * fs ** 2 / (fs - bs + 1) ** 2
            out = self.drop(out, gamma)
        return out


class ResNet12Drop(nn.Module):
    """``resnet12-drop``: ``forward -> (dense NHWC, pooled)``."""

    def __init__(self, channels: Sequence[int] = (64, 160, 320, 640), drop_rate: float = 0.1,
                 dropblock_size: int = 5, img_size: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device: Any = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.out_dim = channels[3]
        cin = 3
        for i, c in enumerate(channels):
            setattr(self, f"layer{i + 1}", nn.Sequential(Res12DropBlock(
                cin, c, pool=i < 3, drop_rate=drop_rate, drop_block=i >= 2,
                block_size=dropblock_size, dtype=dtype)))
            cin = c
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device).eval()

    def forward(self, x: torch.Tensor):
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x, global_avg_pool(x)


models.register("resnet12")(lambda **kw: ResNet12(**{"channels": (64, 128, 256, 512), **kw}))
models.register("resnet12-wide")(lambda **kw: ResNet12(**{"channels": (64, 160, 320, 640),
                                                          **kw}))
models.register("resnet12-drop")(lambda **kw: ResNet12Drop(**kw))
