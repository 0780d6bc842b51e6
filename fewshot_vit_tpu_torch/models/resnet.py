"""ResNet-18/50 (counterpart: ``fewshot_vit_tpu/models/resnet.py``).

torchvision's layout: a 7x7/s2 conv + BN + ReLU stem, a 3x3/s2 max-pool with
padding 1, four stages of BasicBlocks (``resnet18``, [2, 2, 2, 2], out 512)
or Bottlenecks (``resnet50``, [3, 4, 6, 3], out 2048); forward: NHWC
(B, H, W, 3) -> (dense NHWC, pooled). State-dict keys are torchvision's
(``layer2.1.conv1``, ``layer2.0.downsample.1``), the keys
``checkpoint/from_flax.py::resnet_key`` gives.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.registry import models
from .common import BatchNorm2d, Conv, global_avg_pool, init_weights, max_pool


def _conv(cin: int, cout: int, k: int, stride: int, dtype: torch.dtype) -> Conv:
    return Conv(cin, cout, k, stride, k // 2, dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 3, stride, dtype), BatchNorm2d(planes, dtype)
        self.conv2, self.bn2 = _conv(planes, planes, 3, 1, dtype), BatchNorm2d(planes, dtype)
        self.downsample = (nn.Sequential(_conv(cin, planes, 1, stride, dtype),
                                         BatchNorm2d(planes, dtype)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * 4
        self.conv1, self.bn1 = _conv(cin, planes, 1, 1, dtype), BatchNorm2d(planes, dtype)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride, dtype), BatchNorm2d(planes, dtype)
        self.conv3, self.bn3 = _conv(planes, out, 1, 1, dtype), BatchNorm2d(out, dtype)
        self.downsample = (nn.Sequential(_conv(cin, out, 1, stride, dtype),
                                         BatchNorm2d(out, dtype)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    """``forward -> (dense NHWC, pooled)``; ``dtype`` is the compute dtype,
    parameters stay fp32, convs drawn kaiming-normal (fan out) on the CPU
    from ``seed``. ``img_size`` is accepted, as the trainers pass it to
    every encoder, and unused: the net takes any size."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), bottleneck: bool = False,
                 img_size: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 device: Any = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        block = Bottleneck if bottleneck else BasicBlock
        self.out_dim = 512 * block.expansion
        self.conv1, self.bn1 = _conv(3, 64, 7, 2, dtype), BatchNorm2d(64, dtype)
        cin = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n):
                s = stride if b == 0 else 1
                blocks.append(block(cin, planes, s, b == 0 and (s != 1 or cin != planes *
                                                                block.expansion), dtype))
                cin = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device).eval()

    def forward(self, x: torch.Tensor):
        x = max_pool(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x, global_avg_pool(x)


models.register("resnet18")(lambda **kw: ResNet(**{"layers": (2, 2, 2, 2), **kw}))
models.register("resnet50")(lambda **kw: ResNet(**{"layers": (3, 4, 6, 3), "bottleneck": True,
                                                    **kw}))
