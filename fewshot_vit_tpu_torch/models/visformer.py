"""Visformer (counterpart: ``fewshot_vit_tpu/models/visformer.py``).

  * residual 3-conv stem with LeakyReLU(0.1) + 2x2 maxpool, 80x80x3 -> 20x20xD/2;
  * three stages at strides /4, /8, /16 with learned 2-D positional embeddings
    (NCHW parameters, as in the reference); stage dims (D/2, D, 2D);
  * stage-1 blocks are conv-MLP only: 1x1 -> GELU -> 3x3 grouped (g=8) ->
    GELU -> 1x1;
  * stage-2/3 blocks are pre-BN attention + 1x1-conv MLP; the qkv channel
    layout is (3, heads, head_dim) with head_dim = round(dim//heads * ratio),
    so heads*head_dim != dim (252 vs 256, 510 vs 512);
  * forward: NHWC (B, H, W, 3) -> (dense NHWC, pooled). An input that is
    not NHWC-contiguous (an augmentation's resample returns H and W swapped
    in memory) is copied to NHWC once, counted as ``encoder.relayout``:
    from a strided input cuDNN would compute every conv in NCHW, and a 1x1
    over the NHWC view of that memory runs without grad as a batched GEMM
    of W rows (``torch.matmul``'s path for an input it cannot flatten).

State-dict keys follow the reference torch model (``stem.downsample.1``,
``stage2.0.attn.qkv``, ``norm.bn``), the keys the JAX package's
``checkpoint/torch_convert.py::visformer_key`` maps to.

Training mode (``.train()``) runs batch-statistics BN, dropout (``drop_rate``
on the positional sums, in the MLP and after the attention projection;
``attn_drop_rate`` on the attention weights) and stochastic depth (rate
``drop_path_rate * i / (total - 1)`` for block i). Masks come from the
generator named by ``models.common.draws_from``; ``models.common.frozen_bn``
keeps the BNs on running statistics. In training mode attention always takes
the einsum path: the fused kernel has no backward, in either package.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..core import trace
from ..core.device import resolve_device
from ..core.registry import models
from ..kernels.attention import attention_core
from .quant import layer_factory
from .common import (
    BatchNorm,
    BatchNorm2d,
    DropPath,
    Dropout,
    Foldable,
    gelu,
    global_avg_pool,
    kaiming_out_,
    leaky_relu,
    max_pool,
    sow,
    trunc_normal_,
)


class ConvStem(nn.Module):
    """conv3x3/s2 -> BN -> lrelu -> conv3x3 -> BN -> lrelu -> conv3x3 -> BN,
    plus a conv3x3/s2 + BN shortcut, lrelu, then 2x2 maxpool."""

    def __init__(self, hidden: int, out: int, fold_bn: bool = False,
                 dtype: torch.dtype = torch.float32, quant_int8: Any = False):
        super().__init__()
        _, conv3x3 = layer_factory(quant_int8, dtype)
        conv = lambda cin, cout, s: conv3x3(cin, cout, 3, s, 1, bias=fold_bn)
        bn = lambda c: nn.Identity() if fold_bn else BatchNorm2d(c, dtype)
        self.conv1, self.bn1 = conv(3, hidden, 2), bn(hidden)
        self.conv2, self.bn2 = conv(hidden, out, 1), bn(out)
        self.conv3, self.bn3 = conv(out, out, 1), bn(out)
        self.downsample = nn.Sequential(conv(3, out, 2), bn(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = leaky_relu(self.bn1(self.conv1(x)))
        out = leaky_relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        out = leaky_relu(out + self.downsample(x))
        return max_pool(out, 2, 2)


class Mlp(nn.Module):
    """1x1 -> (optional grouped 3x3) -> 1x1 conv MLP."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, group: int = 8,
                 spatial_conv: bool = False, first_bias: bool = False,
                 drop: float = 0.0, dtype: torch.dtype = torch.float32,
                 quant_int8: Any = False):
        super().__init__()
        self.drop = Dropout(drop)
        if spatial_conv:
            hidden = dim * 5 // 6 if group < 2 else dim * 2
        else:
            hidden = int(dim * mlp_ratio)
        dense, conv = layer_factory(quant_int8, dtype)
        self.conv1 = dense(dim, hidden, first_bias)
        self.conv2 = conv(hidden, hidden, 3, 1, 1, group) if spatial_conv else None
        self.conv3 = dense(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(gelu(self.conv1(x)))
        if self.conv2 is not None:
            x = gelu(self.conv2(x))
        return self.drop(self.conv3(x))


class Attention(nn.Module):
    """MHSA over the flattened HxW token axis; 1x1-conv qkv and projection."""

    def __init__(self, dim: int, num_heads: int, head_dim_ratio: float = 1.0,
                 qkv_bias: bool = False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32, quant_int8: Any = False):
        super().__init__()
        self.attn_dropout = Dropout(attn_drop)
        self.proj_dropout = Dropout(proj_drop)
        self.num_heads = num_heads
        self.head_dim = round(dim // num_heads * head_dim_ratio)
        self.scale = self.head_dim ** -0.5
        self.attn_drop = attn_drop
        self.use_pallas = use_pallas
        dense, _ = layer_factory(quant_int8, dtype)
        self.qkv = dense(dim, 3 * num_heads * self.head_dim, qkv_bias)
        self.proj = dense(num_heads * self.head_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        heads, hd = self.num_heads, self.head_dim
        # channel layout matches the torch conv output: (3, heads, head_dim)
        q, k, v = self.qkv(x).reshape(b, h * w, 3, heads, hd).unbind(2)
        # the JAX package's dispatch rule (visformer.py:185): the fused kernel
        # only in eval, without attention dropout, for T >= 64 (stage 2)
        if (self.use_pallas and not self.training and self.attn_drop == 0.0
                and h * w >= 64):
            out = attention_core(q, k, v, self.scale, use_pallas=True)
        else:
            attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * self.scale, dim=-1)
            sow(self, "attn", attn)  # only on this branch, as JAX sows
            attn = self.attn_dropout(attn)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.proj_dropout(self.proj(out.reshape(b, h, w, heads * hd)))


class Block(nn.Module):
    """Pre-BN residual block: [attn] + conv-MLP."""

    def __init__(self, dim: int, num_heads: int, head_dim_ratio: float = 1.0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 attn_drop: float = 0.0, group: int = 8,
                 attn_disabled: bool = False, spatial_conv: bool = False,
                 fold_bn: bool = False, use_pallas: bool = False,
                 drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32, quant_int8: Any = False):
        super().__init__()
        self.fold_bn = fold_bn
        self.drop_path = DropPath(drop_path)
        self.attn = None
        if not attn_disabled:
            if not fold_bn:
                self.norm1 = BatchNorm(dim, dtype)
            self.attn = Attention(dim, num_heads, head_dim_ratio, qkv_bias or fold_bn,
                                  attn_drop, drop, use_pallas, dtype, quant_int8)
        if not fold_bn:
            self.norm2 = BatchNorm(dim, dtype)
        self.mlp = Mlp(dim, mlp_ratio, group, spatial_conv, first_bias=fold_bn, drop=drop,
                       dtype=dtype, quant_int8=quant_int8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.attn is not None:
            x = x + self.drop_path(self.attn(x if self.fold_bn else self.norm1(x)))
        return x + self.drop_path(self.mlp(x if self.fold_bn else self.norm2(x)))


class PatchEmbed(nn.Module):
    """Strided-conv (VALID) patch embedding + optional BN."""

    def __init__(self, patch: int, cin: int, dim: int, use_norm: bool = True,
                 dtype: torch.dtype = torch.float32, quant_int8: Any = False):
        super().__init__()
        self.proj = layer_factory(quant_int8, dtype)[1](cin, dim, patch, patch, 0, bias=True)
        self.norm = BatchNorm(dim, dtype) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x)
        return x if self.norm is None else self.norm(x)


def drop_path_ladder(rate: float, total: int) -> list:
    """Stochastic-depth rate of each of ``total`` blocks: linspace(0, rate, total)."""
    return [rate * i / max(total - 1, 1) for i in range(total)]


class Visformer(Foldable, nn.Module):
    """3-stage conv-attention hybrid; ``forward -> (dense NHWC, pooled)``.

    ``use_pallas_attn`` keeps the JAX package's name so ``encoder_args``
    carry over unchanged; in this package it selects the CUDA fused-MHSA
    kernel (``kernels/attention.py``) for the attention blocks that the
    dispatch rule admits. ``fold_bn`` builds the architecture whose frozen
    BNs are folded into the adjacent convs (``models/fold.py``);
    ``quant_int8`` (``True``: dynamic activation scales, ``"static"``:
    calibrated ones; needs ``fold_bn``) makes the stem convs, the patch
    embeds, the MLP's 1x1s and grouped 3x3, qkv and proj int8 layers
    (``models/quant.py``), as in JAX; attention dispatch is unchanged.
    ``dtype`` is the compute dtype; parameters stay fp32. Weights are
    initialized on the CPU from ``torch.Generator().manual_seed(seed)`` and
    then moved to ``device``.
    """

    def __init__(
        self,
        img_size: int = 80,
        init_channels: Optional[int] = 64,
        embed_dim: int = 256,
        depth: Sequence[int] = (4, 2, 3),
        num_heads: int = 6,
        mlp_ratio: float = 4.0,
        group: int = 8,
        attn_stage: str = "011",
        spatial_conv: str = "100",
        qkv_bias: bool = False,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        embed_norm: bool = True,
        fold_bn: bool = False,
        quant_int8: Any = False,
        use_pallas_attn: bool = False,
        dtype: torch.dtype = torch.float32,
        device: Any = "cuda",
        seed: int = 0,
    ):
        super().__init__()
        if quant_int8 and not fold_bn:
            raise ValueError("quant_int8 requires fold_bn=True "
                             "(quantize FOLDED weights, models/quant.py)")
        if quant_int8 not in (False, True, "static"):
            raise ValueError(f"quant_int8 is False, True or 'static', not {quant_int8!r}")
        device = resolve_device(device)
        self.config = dict(
            img_size=img_size, init_channels=init_channels, embed_dim=embed_dim,
            depth=tuple(depth), num_heads=num_heads, mlp_ratio=mlp_ratio,
            group=group, attn_stage=attn_stage, spatial_conv=spatial_conv,
            qkv_bias=qkv_bias, drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
            drop_path_rate=drop_path_rate, embed_norm=embed_norm, fold_bn=fold_bn,
            quant_int8=quant_int8, use_pallas_attn=use_pallas_attn, dtype=dtype,
        )
        self.out_dim = embed_dim * 2
        self.fold_bn = fold_bn
        d1, d2, d3 = depth
        dims = (embed_dim // 2, embed_dim, embed_dim * 2)
        pe_norm = embed_norm and not fold_bn
        self.drop_path_rates = drop_path_ladder(drop_path_rate, d1 + d2 + d3)
        self.pos_drop = Dropout(drop_rate)

        def stage(n, s_idx, ratio, first):
            return nn.ModuleList(
                Block(dims[s_idx], num_heads, ratio, mlp_ratio, qkv_bias,
                      attn_drop_rate, group, attn_stage[s_idx] == "0",
                      spatial_conv[s_idx] == "1", fold_bn, use_pallas_attn,
                      drop_rate, self.drop_path_rates[first + i], dtype, quant_int8)
                for i in range(n))

        if init_channels is not None:
            self.stem = ConvStem(init_channels, dims[0], fold_bn, dtype, quant_int8)
            size = img_size // 4
        else:
            self.patch_embed1 = PatchEmbed(8, 3, dims[0], pe_norm, dtype, quant_int8)
            size = img_size // 8
        self.pos_embed1 = nn.Parameter(torch.empty(1, dims[0], size, size))
        self.stage1 = stage(d1, 0, 0.5, 0)
        size //= 2
        self.patch_embed2 = PatchEmbed(2, dims[0], dims[1], pe_norm, dtype, quant_int8)
        self.pos_embed2 = nn.Parameter(torch.empty(1, dims[1], size, size))
        self.stage2 = stage(d2, 1, 1.0, d1)
        size //= 2
        self.patch_embed3 = PatchEmbed(2, dims[1], dims[2], pe_norm, dtype, quant_int8)
        self.pos_embed3 = nn.Parameter(torch.empty(1, dims[2], size, size))
        self.stage3 = stage(d3, 2, 1.0, d1 + d2)
        self.norm = BatchNorm(dims[2], dtype)

        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.startswith("pos_embed"):
                trunc_normal_(p, 0.02, gen)
            elif p.dim() == 4:
                kaiming_out_(p, gen)
        self.to(device).eval()

    def forward(self, x: torch.Tensor):
        # spans: a stage holds the patch embedding that feeds it; stage 3 the
        # final norm and pooling
        with trace.span("encoder"):
            if not x.is_contiguous():
                trace.count("encoder.relayout")
                x = x.contiguous()
            with trace.span("encoder.stem"):
                x = self.stem(x) if hasattr(self, "stem") else self.patch_embed1(x)
                x = self.pos_drop(x + self.pos_embed1.permute(0, 2, 3, 1))
            with trace.span("encoder.stage1"):
                for blk in self.stage1:
                    x = blk(x)
            with trace.span("encoder.stage2"):
                x = self.pos_drop(self.patch_embed2(x) + self.pos_embed2.permute(0, 2, 3, 1))
                for blk in self.stage2:
                    x = blk(x)
            with trace.span("encoder.stage3"):
                x = self.pos_drop(self.patch_embed3(x) + self.pos_embed3.permute(0, 2, 3, 1))
                for blk in self.stage3:
                    x = blk(x)
                x = self.norm(x)
                return x, global_avg_pool(x)


_VARIANTS = {
    # reference visformer_small_80, registered as 'visformer_micro_80'
    "visformer_micro_80": dict(img_size=80, init_channels=64, embed_dim=256,
                               depth=(4, 2, 3), num_heads=6, group=8),
    "visformer_tiny_80": dict(img_size=80, init_channels=16, embed_dim=192,
                              depth=(7, 4, 4), num_heads=3, group=8),
    "visformer_small": dict(img_size=224, init_channels=32, embed_dim=384,
                            depth=(7, 4, 4), num_heads=6, group=8),
    "net5_80": dict(img_size=80, init_channels=32, embed_dim=384, depth=(4, 4, 4),
                    num_heads=6, group=1, attn_stage="111", spatial_conv="111",
                    embed_norm=False),
}

for _name, _cfg in _VARIANTS.items():
    models.register(_name)(lambda _cfg=_cfg, **kw: Visformer(**{**_cfg, **kw}))
