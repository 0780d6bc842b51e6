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

import contextlib
import contextvars
import math
from typing import Any, Iterable, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # torch BatchNorm2d default, used across the zoo
BN_MOMENTUM = 0.1  # torch's convention (flax: momentum 0.9)

# --- trace-time switches of a training forward ------------------------------------
# ``frozen_bn()`` puts ONLY the BatchNorms on their running statistics while
# the model stays in training mode (the reference's ``utils.freeze_bn``), and
# ``draws_from(generator)`` names the ``torch.Generator`` every dropout and
# drop-path mask of the forward is drawn from.
_bn_frozen: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "fewshot_vit_bn_frozen", default=False)
_generator: contextvars.ContextVar[Optional[torch.Generator]] = contextvars.ContextVar(
    "fewshot_vit_mask_generator", default=None)
_injected: contextvars.ContextVar[Optional[Iterator[torch.Tensor]]] = contextvars.ContextVar(
    "fewshot_vit_injected_draws", default=None)


@contextlib.contextmanager
def frozen_bn() -> Iterator[None]:
    """Within this context every zoo BatchNorm normalizes with its running
    statistics and leaves them untouched, whatever the module's mode; dropout
    and drop-path stay stochastic."""
    token = _bn_frozen.set(True)
    try:
        yield
    finally:
        _bn_frozen.reset(token)


def bn_uses_running_stats(training: bool) -> bool:
    """Eval mode, or training mode inside ``frozen_bn()``."""
    return (not training) or _bn_frozen.get()


@contextlib.contextmanager
def draws_from(generator: Optional[torch.Generator]) -> Iterator[None]:
    """Within this context ``Dropout`` and ``DropPath`` draw their masks from
    ``generator`` (on the tensors' device). ``None`` is torch's default
    generator; the trainers always pass one seeded from
    (seed, epoch, step[, episode])."""
    token = _generator.set(generator)
    try:
        yield
    finally:
        _generator.reset(token)


@contextlib.contextmanager
def injected_draws(masks: Iterable[torch.Tensor]) -> Iterator[None]:
    """Within this context every Bernoulli draw of the forward (``Dropout``,
    ``DropPath``, ``DropBlock``) takes the next of ``masks`` (bool, True where
    the draw succeeded) instead of drawing, in call order: the parity tests
    replay another framework's draws through it. A mask of the wrong shape
    raises."""
    token = _injected.set(iter(masks))
    try:
        yield
    finally:
        _injected.reset(token)


# --- attention capture ---------------------------------------------------------
# The JAX zoo's ``self.sow("intermediates", ...)``: inside ``capture_attention()``
# the Visformer, NesT and Swin attention modules record their post-softmax
# weights (Swin also its stitched, unshifted map) where JAX sows them. Outside
# it, ``sow`` reads one context variable and records nothing.
_captured: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "fewshot_vit_captured_attention", default=None)


@contextlib.contextmanager
def capture_attention() -> Iterator[list]:
    """Yields a list that fills, in call order (which is depth order), with
    ``(module, key, tensor)`` for every sow of the forwards run inside:
    ``key`` is ``"attn"`` (post-softmax weights) or ``"attn_map"`` (Swin's
    image-plane map). Capture changes no dispatch: a block whose attention
    runs through the fused kernel records nothing, as in JAX."""
    found: list = []
    token = _captured.set(found)
    try:
        yield found
    finally:
        _captured.reset(token)


def capturing() -> bool:
    """True inside ``capture_attention()``."""
    return _captured.get() is not None


def sow(module: nn.Module, key: str, value: torch.Tensor) -> None:
    """Record ``value`` under ``key`` for ``module`` inside ``capture_attention()``."""
    found = _captured.get()
    if found is not None:
        found.append((module, key, value.detach()))


def _uniform(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=_generator.get(), device=like.device, dtype=torch.float32)


def bernoulli(p, shape, like: torch.Tensor) -> torch.Tensor:
    """A bool draw of ``shape``, True with probability ``p`` (a float or a
    0-d tensor), on ``like``'s device; the next injected mask inside
    ``injected_draws``."""
    masks = _injected.get()
    if masks is not None:
        mask = next(masks)
        if tuple(mask.shape) != tuple(shape):
            raise ValueError(f"injected draw of shape {tuple(mask.shape)}, expected {tuple(shape)}")
        return mask.to(device=like.device, dtype=torch.bool)
    return _uniform(shape, like) < p


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


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init, ``variance_scaling(1, fan_in,
    truncated_normal)``, over a torch layout (fan_in = I * kh * kw)."""
    std = math.sqrt(1.0 / math.prod(t.shape[1:])) / 0.87962566103423978
    return trunc_normal_(t, std, generator)


def kaiming_out_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Kaiming normal, fan_out, relu gain: std = sqrt(2 / (O * kh * kw))."""
    fan_out = t.shape[0] * math.prod(t.shape[2:])
    with torch.no_grad():
        return t.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


class Conv(nn.Module):
    """A conv over NHWC input with an OIHW ``weight``. A 1x1 stride-1 conv is
    the dense layer over the channel axis it equals (``F.linear``). ``init``
    names the kernel init ``init_weights`` applies (``INITS``)."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.float32, init: str = "kaiming"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.init = init
        self.pointwise = k == 1 and stride == 1 and groups == 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        x = x.to(self.dtype)
        if self.pointwise:
            return F.linear(x, w.flatten(1), b)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride, self.padding, 1, self.groups)
        return y.permute(0, 2, 3, 1)


class Linear(nn.Module):
    """flax's ``Dense`` over the last axis with an ``nn.Linear`` weight
    (O, I): input and weights cast to ``dtype``, output in ``dtype``."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, init: str = "trunc"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.dtype = dtype
        self.init = init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


INITS = {
    "trunc": lambda t, g: trunc_normal_(t, 0.02, g),  # trunc_normal_init(0.02)
    "kaiming": kaiming_out_,                         # kaiming_out_init
    "lecun": lecun_normal_,                          # flax's default
}


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every ``Conv`` / ``Linear`` kernel of ``module`` with its own
    ``init``, in module order; biases stay 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, Linear)):
                INITS[m.init](m.weight, generator)


class LayerNorm(nn.Module):
    """flax's ``LayerNorm`` over the last axis: fp32 statistics and affine,
    output in ``dtype``; ``weight`` / ``bias`` as ``nn.LayerNorm``."""

    def __init__(self, c: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps, self.dtype = eps, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


def max_pool(x: torch.Tensor, k: int, stride: int, padding: int = 0) -> torch.Tensor:
    """NHWC max-pool; padding is -inf, as flax's ``max_pool``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, padding).permute(0, 2, 3, 1)


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


class BatchNorm2d(FrozenBatchNorm):
    """BatchNorm over the channel (last) axis that follows flax's
    ``nn.BatchNorm``: in eval mode, or inside ``frozen_bn()``, the
    ``FrozenBatchNorm`` affine; in training mode batch statistics in fp32 over
    every other axis ((B, H, W) of NHWC, (B, N) of LeViT's tokens), the
    variance as
    ``E[x^2] - E[x]^2`` clamped at 0, and running statistics updated with
    momentum 0.1 from the BIASED batch variance (``torch.nn.BatchNorm2d``
    stores the unbiased one; the JAX package is the reference here)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if bn_uses_running_stats(self.training):
            return super().forward(x)
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=dims)
        var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, BN_MOMENTUM)
            self.running_var.lerp_(var, BN_MOMENTUM)
        y = (xf - mean) * (torch.rsqrt(var + BN_EPS) * self.weight) + self.bias
        return y.to(self.dtype)


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from the ``draws_from`` generator, or
    from ``mask`` (bool, broadcastable to ``x``: True keeps). Identity at rate 0
    and in eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        if mask is None:
            mask = bernoulli(keep, x.shape, x)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(Dropout):
    """Per-sample stochastic depth: one draw per batch row, mask of shape
    (B, 1, 1, 1); kept rows are scaled by ``1 / keep``."""

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if mask is None:
            mask = bernoulli(1.0 - self.rate, (x.shape[0],) + (1,) * (x.dim() - 1), x)
        return super().forward(x, mask)


class BatchNorm(nn.Module):
    """The zoo's BatchNorm wrapper: a ``BatchNorm2d`` named ``bn``
    (state-dict keys ``<name>.bn.weight`` ...), as in the JAX package."""

    def __init__(self, c: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn = BatchNorm2d(c, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class Foldable:
    """For the encoders with a BN folder (``models/fold.py``): ``clone`` and
    the guard that keeps a ``fold_bn`` encoder out of training mode. The
    encoder keeps its constructor arguments in ``self.config``."""

    def clone(self, **overrides: Any):
        """A freshly initialized encoder of this one's config, on its device."""
        device = next(self.parameters()).device
        return type(self)(**{**self.config, **overrides}, device=device)

    def train(self, mode: bool = True):
        if mode and self.config["fold_bn"]:
            raise ValueError("a fold_bn encoder has no BatchNorm left to train; "
                             "build it with fold_bn=False for training")
        return super().train(mode)
