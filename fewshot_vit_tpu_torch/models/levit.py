"""LeViT (counterpart: ``fewshot_vit_tpu/models/levit.py``).

  * Visformer's residual 3-conv stem as patch embed, 80x80 -> 20x20 tokens;
  * ``LinearNorm``: a bias-free Linear + BatchNorm over the token-flattened
    batch (statistics over B * N), the second norm of each attention and MLP
    initialized to scale 0;
  * attention: per-head (key_dim, key_dim, attn_ratio * key_dim) split of
    qkv, an additive learned bias per head indexed by a static offset table,
    hard-swish before the projection;
  * ``AttentionSubsample`` between stages: queries from the stride-2
    subsampled tokens, keys and values at full resolution (20 -> 10 -> 5);
  * ONE drop-path module shared by every residual; each call draws anew;
  * ``fold_bn``: biased Linears and no BatchNorm (``models/fold.py::fold_levit``);
  * forward: NHWC (B, H, W, 3) -> (dense NHWC, pooled).

Spans (``core/trace.py``): ``encoder`` > ``encoder.stem`` (the ConvStem),
``encoder.stage1`` .. ``encoder.stage<n>`` (a stage's blocks with the
``LevitAttentionSubsample`` and MLP that feed it; the last one the pooling
too), and in every ``LevitAttention`` and ``LevitAttentionSubsample`` call
``encoder.bias_attn`` (the qkv, or kv and q, LinearNorms through the
attention and the hard-swish to the proj LinearNorm; the residual add and
the MLP stay outside): 8 a ``levit_micro_80`` forward. Counter
``encoder.attn_scores``: B * heads * Nq * Nkv a call (1,125,000 an image
for ``levit_micro_80`` at 80 px).

State-dict keys are the reference's, Residual-wrapped blocks under ``.m``
(``blocks.0.m.qkv.c``, ``blocks.0.m.proj.1.c``, ``blocks.1.m.0.bn``,
``blocks.2.q.1.c``), the keys ``checkpoint/from_flax.py::levit_key`` gives.
The bias index tables are non-persistent buffers.
"""

from __future__ import annotations

import itertools
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import trace
from ..core.device import resolve_device
from ..core.registry import models
from .common import BatchNorm2d, DropPath, Foldable, Linear, init_weights
from .visformer import ConvStem


class LinearNorm(nn.Module):
    """``c``: a Linear (biased only when folded); ``bn``: its BatchNorm."""

    def __init__(self, cin: int, cout: int, bn_weight_init: float = 1.0,
                 fold_bn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c = Linear(cin, cout, fold_bn, dtype, init="lecun")
        self.bn = None
        if not fold_bn:
            self.bn = BatchNorm2d(cout, dtype)
            with torch.no_grad():
                self.bn.weight.fill_(bn_weight_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.c(x)
        return x if self.bn is None else self.bn(x)


class Hardswish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.hardswish(x)


class Subsample(nn.Module):
    """Tokens of a res x res grid -> those at stride ``stride``."""

    def __init__(self, res: int, stride: int):
        super().__init__()
        self.res, self.stride = res, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        x = x.reshape(b, self.res, self.res, c)[:, ::self.stride, ::self.stride]
        return x.reshape(b, -1, c)


def attention_bias_idxs(res_q: int, res_kv: int, stride: int = 1):
    """Static (Nq, Nkv) index into the offset table, and the table's size."""
    points_kv = list(itertools.product(range(res_kv), range(res_kv)))
    points_q = list(itertools.product(range(res_q), range(res_q)))
    offsets: dict = {}
    idxs = []
    for p1 in points_q:
        for p2 in points_kv:
            off = (abs(p1[0] * stride - p2[0]), abs(p1[1] * stride - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    return np.asarray(idxs, np.int64).reshape(len(points_q), len(points_kv)), len(offsets)


def _biased_softmax(q, k, biases, idxs, scale):
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    return torch.softmax(attn + biases[:, idxs][None].to(attn.dtype), dim=-1)


class LevitAttention(nn.Module):
    def __init__(self, dim: int, key_dim: int, num_heads: int, attn_ratio: int,
                 resolution: int, fold_bn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.key_dim, self.num_heads = key_dim, num_heads
        self.d = attn_ratio * key_dim
        self.qkv = LinearNorm(dim, num_heads * (2 * key_dim + self.d), fold_bn=fold_bn, dtype=dtype)
        self.proj = nn.Sequential(Hardswish(), LinearNorm(num_heads * self.d, dim, 0.0, fold_bn,
                                                          dtype))
        idxs, n_off = attention_bias_idxs(resolution, resolution)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, n_off))
        self.register_buffer("attention_bias_idxs", torch.from_numpy(idxs), persistent=False)

    @trace.span("encoder.bias_attn")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        kd, h = self.key_dim, self.num_heads
        trace.count("encoder.attn_scores", b * h * n * n)
        q, k, v = self.qkv(x).reshape(b, n, h, 2 * kd + self.d).split([kd, kd, self.d], dim=-1)
        attn = _biased_softmax(q, k, self.attention_biases, self.attention_bias_idxs, kd ** -0.5)
        return self.proj(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, h * self.d))


class LevitAttentionSubsample(nn.Module):
    def __init__(self, cin: int, out_dim: int, key_dim: int, num_heads: int, attn_ratio: int,
                 resolution: int, stride: int = 2, fold_bn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.key_dim, self.num_heads = key_dim, num_heads
        self.d = attn_ratio * key_dim
        res_ = (resolution - 1) // stride + 1
        self.kv = LinearNorm(cin, num_heads * (key_dim + self.d), fold_bn=fold_bn, dtype=dtype)
        self.q = nn.Sequential(Subsample(resolution, stride),
                               LinearNorm(cin, num_heads * key_dim, fold_bn=fold_bn, dtype=dtype))
        self.proj = nn.Sequential(Hardswish(), LinearNorm(num_heads * self.d, out_dim,
                                                          fold_bn=fold_bn, dtype=dtype))
        idxs, n_off = attention_bias_idxs(res_, resolution, stride)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, n_off))
        self.register_buffer("attention_bias_idxs", torch.from_numpy(idxs), persistent=False)

    @trace.span("encoder.bias_attn")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        kd, h = self.key_dim, self.num_heads
        k, v = self.kv(x).reshape(b, n, h, kd + self.d).split([kd, self.d], dim=-1)
        q = self.q(x)
        trace.count("encoder.attn_scores", b * h * q.shape[1] * n)
        q = q.reshape(b, q.shape[1], h, kd)
        attn = _biased_softmax(q, k, self.attention_biases, self.attention_bias_idxs, kd ** -0.5)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.proj(out.reshape(b, out.shape[1], h * self.d))


def levit_mlp(dim: int, hidden: int, fold_bn: bool, dtype: torch.dtype) -> nn.Sequential:
    return nn.Sequential(LinearNorm(dim, hidden, fold_bn=fold_bn, dtype=dtype), Hardswish(),
                         LinearNorm(hidden, dim, 0.0, fold_bn, dtype))


class Residual(nn.Module):
    """A residual branch ``m``; the model adds it through its shared drop-path."""

    def __init__(self, m: nn.Module):
        super().__init__()
        self.m = m


class Levit(Foldable, nn.Module):
    """``forward -> (dense NHWC, pooled)``; ``dtype`` is the compute dtype,
    parameters stay fp32, weights drawn on the CPU from ``seed``."""

    def __init__(
        self,
        img_size: int = 80,
        patch_size: int = 4,
        embed_dim: Sequence[int] = (256, 384, 512),
        key_dim: int = 32,
        depth: Sequence[int] = (1, 2, 3),
        num_heads: Sequence[int] = (4, 6, 8),
        attn_ratio: int = 2,
        mlp_ratio: int = 2,
        stem_hidden: int = 64,
        drop_path_rate: float = 0.0,
        fold_bn: bool = False,
        dtype: torch.dtype = torch.float32,
        device: Any = "cuda",
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.config = dict(img_size=img_size, patch_size=patch_size, embed_dim=tuple(embed_dim),
                           key_dim=key_dim, depth=tuple(depth), num_heads=tuple(num_heads),
                           attn_ratio=attn_ratio, mlp_ratio=mlp_ratio, stem_hidden=stem_hidden,
                           drop_path_rate=drop_path_rate, fold_bn=fold_bn, dtype=dtype)
        self.out_dim = embed_dim[-1]
        self.patch_embed = ConvStem(stem_hidden, embed_dim[0], fold_bn, dtype)
        self.drop_path = DropPath(drop_path_rate)
        res = img_size // 4  # the stem's stride
        blocks = []
        self.stage_ends = []  # blocks[start:end] of each stage, its feeding blocks included
        for i, ed in enumerate(embed_dim):
            for _ in range(depth[i]):
                blocks.append(Residual(LevitAttention(ed, key_dim, num_heads[i], attn_ratio, res,
                                                      fold_bn, dtype)))
                blocks.append(Residual(levit_mlp(ed, ed * mlp_ratio, fold_bn, dtype)))
            self.stage_ends.append(len(blocks))
            if i < len(embed_dim) - 1:
                # down_ops: heads embed_dim // key_dim, attn_ratio 4, stride 2
                blocks.append(LevitAttentionSubsample(ed, embed_dim[i + 1], key_dim,
                                                      ed // key_dim, 4, res, 2, fold_bn, dtype))
                res = (res - 1) // 2 + 1
                blocks.append(Residual(levit_mlp(embed_dim[i + 1], embed_dim[i + 1] * 2,
                                                 fold_bn, dtype)))
        self.blocks = nn.ModuleList(blocks)
        self.res = res

        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device).eval()

    @trace.span("encoder")
    def forward(self, x: torch.Tensor):
        with trace.span("encoder.stem"):
            x = self.patch_embed(x)
        b, r, _, c = x.shape
        x = x.reshape(b, r * r, c)
        start = 0
        for i, end in enumerate(self.stage_ends, start=1):
            with trace.span(f"encoder.stage{i}"):
                for blk in self.blocks[start:end]:
                    if isinstance(blk, Residual):
                        x = x + self.drop_path(blk.m(x))
                    else:
                        x = blk(x)
                start = end
                if i == len(self.stage_ends):  # the last stage: pooling
                    return x.reshape(b, self.res, self.res, -1), x.mean(dim=1)


models.register("levit_micro_80")(
    # the reference's levit_384 redefinition at 80 px
    lambda **kw: Levit(**{"img_size": 80, "embed_dim": (256, 384, 512), "key_dim": 32,
                          "depth": (1, 2, 3), "num_heads": (4, 6, 8), **kw}))
