"""Shared building blocks (counterpart: ``fewshot_vit_tpu/models/common.py``).

Encoders take and return NHWC tensors, as the JAX zoo does, and return
``(dense_map, pooled)``. Weights keep PyTorch's layouts (conv OIHW, 1x1
convs as (O, I, 1, 1)) so reference ``.pth`` state dicts fit them.

Mixed precision follows flax's ``dtype=``: parameters stay fp32, each
conv/dense casts its input and weights to the compute dtype, BatchNorm
computes in fp32 and returns the compute dtype. Adding an fp32 positional
embedding promotes the residual stream to fp32 in both frameworks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # torch BatchNorm2d default, used across the zoo


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU (torch ``nn.GELU`` default)."""
    return F.gelu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC (B, H, W, C) -> (B, C)."""
    return x.mean(dim=(1, 2))


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std, as the JAX zoo's ``trunc_normal_init``."""
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def kaiming_out_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Kaiming normal, fan_out, relu gain: std = sqrt(2 / (O * kh * kw))."""
    fan_out = t.shape[0] * math.prod(t.shape[2:])
    with torch.no_grad():
        return t.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


class Conv(nn.Module):
    """A conv over NHWC input with an OIHW ``weight``. A 1x1 stride-1 conv is
    the dense layer over the channel axis it equals (``F.linear``)."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.pointwise = k == 1 and stride == 1 and groups == 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        x = x.to(self.dtype)
        if self.pointwise:
            return F.linear(x, w.flatten(1), b)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride, self.padding, 1, self.groups)
        return y.permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm over the channel (last) axis: fp32 math, eps 1e-5,
    output in ``dtype``. Parameter names follow ``nn.BatchNorm2d``."""

    def __init__(self, c: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (x.float() - self.running_mean) * mul + self.bias
        return y.to(self.dtype)


class BatchNorm(nn.Module):
    """The zoo's BatchNorm wrapper: a ``FrozenBatchNorm`` named ``bn``
    (state-dict keys ``<name>.bn.weight`` ...), as in the JAX package."""

    def __init__(self, c: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn = FrozenBatchNorm(c, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)
