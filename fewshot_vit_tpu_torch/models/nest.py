"""NesT, the nested hierarchical transformer (counterpart:
``fewshot_vit_tpu/models/nest.py``).

  * a 4x4/s4 patch embed, or Visformer's residual 3-conv stem (``resembed``);
  * three levels of [16, 4, 1] non-overlapping square blocks of the token
    grid; each level: a ConvPool aggregation (3x3 conv, channel LayerNorm
    eps 1e-6, 3x3/s2 max-pool with padding 1) from level 1 on, a
    (1, T, N, C) positional embedding, pre-LN transformer layers attending
    within each block;
  * attention kinds: standard MHSA, ConViT's gated positional attention
    (GPSA, levels < ``gpsa_levels``) and Swin's relative position bias over
    the block window (``rel_bias``); the standard and rel kinds merge heads
    head-dim-major (channel = d * H + h) and GPSA head-major, as the
    reference, for weight compatibility;
  * ``last_level_2x``: the last level skips the ConvPool's downsample and
    runs at twice the block edge (``nest_micro_resembed_2x_80``);
  * forward: NHWC (B, H, W, 3) -> (dense NHWC, pooled).

State-dict keys are the reference's (``levels.1.transformer_encoder.0.attn.qkv``,
``levels.0.pos_embed``, ``levels.1.pool.conv``, ``patch_embed.proj``), the
keys ``checkpoint/from_flax.py::nest_key`` gives.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..core.registry import models
from .common import (
    Conv,
    DropPath,
    Dropout,
    LayerNorm,
    Linear,
    init_weights,
    max_pool,
    sow,
    trunc_normal_,
)
from .swin import Mlp, relative_position_index
from .visformer import ConvStem, drop_path_ladder

LN_EPS = 1e-6


def blockify(x: torch.Tensor, block: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, T, N, C) non-overlapping square blocks."""
    b, h, w, c = x.shape
    gh, gw = h // block, w // block
    x = x.reshape(b, gh, block, gw, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, block * block, c)


def deblockify(x: torch.Tensor, block: int) -> torch.Tensor:
    """(B, T, N, C) -> (B, H, W, C)."""
    b, t, _, c = x.shape
    g = int(math.sqrt(t))
    x = x.reshape(b, g, g, block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g * block, g * block, c)


class NestAttention(nn.Module):
    """MHSA over the block-local token axis of (B, T, N, C); with ``window``
    set, plus a learned relative position bias over the block (``rel``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, window: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, qkv_bias, dtype)
        self.proj = Linear(dim, dim, True, dtype)
        self.attn_drop, self.proj_drop = Dropout(attn_drop), Dropout(proj_drop)
        self.window = window
        if window:
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros((2 * window - 1) ** 2, num_heads))
            self.register_buffer("relative_position_index", torch.from_numpy(
                relative_position_index(window).reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, n, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k, v = self.qkv(x).reshape(b, t, n, 3, h, hd).unbind(3)
        attn = torch.einsum("btqhd,btkhd->bthqk", q, k) * hd ** -0.5
        if self.window:
            bias = self.relative_position_bias_table[self.relative_position_index]
            attn = attn + bias.reshape(n, n, h).permute(2, 0, 1).to(attn.dtype)
        attn = torch.softmax(attn, dim=-1)
        if not self.window:  # JAX sows in its standard attention, not in the rel one
            sow(self, "attn", attn)
        attn = self.attn_drop(attn)
        # head-dim-major merge: channel = d * H + h (the reference's permute)
        out = torch.einsum("bthqk,btkhd->btqdh", attn, v).reshape(b, t, n, c)
        return self.proj_drop(self.proj(out))


def gpsa_rel_indices(n: int) -> np.ndarray:
    """(N, N, 3) per-block relative coordinates (dx, dy, dx^2 + dy^2)."""
    g = int(math.sqrt(n))
    ind = np.arange(g)[None, :] - np.arange(g)[:, None]
    indx = np.tile(ind, (g, g))
    indy = np.repeat(np.repeat(ind, g, axis=0), g, axis=1)
    return np.stack([indx, indy, indx ** 2 + indy ** 2], axis=-1).astype(np.float32)


class NestGPSA(nn.Module):
    """Gated positional self-attention over block-local tokens:
    (1 - sigmoid(g)) * softmax(q k^T) + sigmoid(g) * softmax(pos_proj(rel)),
    renormalized; heads merged head-major."""

    def __init__(self, dim: int, num_heads: int, block: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qk = Linear(dim, 2 * dim, qkv_bias, dtype)
        self.v = Linear(dim, dim, qkv_bias, dtype)
        self.pos_proj = Linear(3, num_heads, True, dtype)
        self.gating_param = nn.Parameter(torch.ones(num_heads))
        self.proj = Linear(dim, dim, True, dtype)
        self.attn_drop, self.proj_drop = Dropout(attn_drop), Dropout(proj_drop)
        self.register_buffer("rel_indices", torch.from_numpy(gpsa_rel_indices(block * block)),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, n, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k = self.qk(x).reshape(b, t, n, 2, h, hd).unbind(3)
        v = self.v(x).reshape(b, t, n, h, hd)
        patch = torch.softmax(torch.einsum("btqhd,btkhd->bhtqk", q, k) * hd ** -0.5, dim=-1)
        pos = torch.softmax(self.pos_proj(self.rel_indices).permute(2, 0, 1), dim=-1)
        gate = torch.sigmoid(self.gating_param).reshape(1, h, 1, 1, 1)
        attn = (1.0 - gate) * patch + gate * pos[None, :, None].to(patch.dtype)
        attn = self.attn_drop(attn / attn.sum(dim=-1, keepdim=True))
        # the fp32 gate promotes attn, and jnp.einsum promotes v with it
        out = torch.einsum("bhtqk,btkhd->bhtqd", attn, v.to(attn.dtype))
        # (B, H, T, N, d) -> (B, T, H, N, d) -> (B, T, N, C): head-major flat
        out = out.permute(0, 2, 1, 3, 4).reshape(b, t, n, c)
        return self.proj_drop(self.proj(out))


class NestTransformerLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, attn_type: str = "standard", block: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, LN_EPS, dtype)
        if attn_type == "gpsa":
            self.attn = NestGPSA(dim, num_heads, block, qkv_bias, attn_drop, drop, dtype)
        else:
            self.attn = NestAttention(dim, num_heads, qkv_bias, attn_drop, drop,
                                      block if attn_type == "rel" else 0, dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, LN_EPS, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class ConvPool(nn.Module):
    """Block aggregation: 3x3 conv, channel LayerNorm, 3x3 max-pool with
    padding 1 (stride 1 for the 2x last level)."""

    def __init__(self, cin: int, dim: int, stride: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(cin, dim, 3, 1, 1, bias=True, dtype=dtype, init="trunc")
        self.norm = LayerNorm(dim, LN_EPS, dtype)
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(self.norm(self.conv(x)), 3, self.stride, 1)


class PatchEmbed(nn.Module):
    """The plain VALID patch conv, under the reference's ``patch_embed.proj``."""

    def __init__(self, patch: int, cin: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv(cin, dim, patch, patch, 0, bias=True, dtype=dtype, init="trunc")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class NestLevel(nn.Module):
    """One level: [pool], pos_embed, layers (``transformer_encoder``)."""

    def __init__(self, layers, pos_shape, pool=None):
        super().__init__()
        if pool is not None:
            self.pool = pool
        self.pos_embed = nn.Parameter(torch.zeros(pos_shape))
        self.transformer_encoder = nn.ModuleList(layers)


class Nest(nn.Module):
    """``forward -> (dense NHWC, pooled)``; ``dtype`` is the compute dtype,
    parameters stay fp32, weights drawn on the CPU from ``seed``."""

    def __init__(
        self,
        img_size: int = 80,
        patch_size: int = 4,
        embed_dims: Sequence[int] = (96, 192, 384),
        num_heads: Sequence[int] = (3, 6, 12),
        depths: Sequence[int] = (2, 3, 3),
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.5,
        conv_stem: bool = False,
        stem_hidden: int = 64,
        gpsa_levels: int = 0,
        rel_bias: bool = False,
        last_level_2x: bool = False,
        dtype: torch.dtype = torch.float32,
        device: Any = "cuda",
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.out_dim = embed_dims[-1]
        n_levels = len(embed_dims)
        num_blocks = [4 ** (n_levels - 1 - i) for i in range(n_levels)]
        grid = img_size // patch_size
        block = grid // int(math.sqrt(num_blocks[0]))
        self.blocks_edge = []
        self.pos_drop = Dropout(drop_rate)
        if conv_stem:
            self.patch_embed = ConvStem(stem_hidden, embed_dims[0], dtype=dtype)
        else:
            self.patch_embed = PatchEmbed(patch_size, 3, embed_dims[0], dtype)
        dpr = drop_path_ladder(drop_path_rate, sum(depths))
        levels, first = [], 0
        for lvl, dim in enumerate(embed_dims):
            hires = last_level_2x and lvl == n_levels - 1
            lb = block * 2 if hires else block
            self.blocks_edge.append(lb)
            attn_type = "gpsa" if lvl < gpsa_levels else "rel" if rel_bias else "standard"
            layers = [NestTransformerLayer(dim, num_heads[lvl], mlp_ratio, qkv_bias, drop_rate,
                                           attn_drop_rate, dpr[first + j], attn_type, lb, dtype)
                      for j in range(depths[lvl])]
            pool = (ConvPool(embed_dims[lvl - 1], dim, 1 if hires else 2, dtype)
                    if lvl > 0 else None)
            levels.append(NestLevel(layers, (1, num_blocks[lvl], lb * lb, dim), pool))
            first += depths[lvl]
        self.levels = nn.ModuleList(levels)
        self.norm = LayerNorm(embed_dims[-1], LN_EPS, dtype)

        gen = torch.Generator().manual_seed(seed)
        init_weights(self, gen)
        for name, p in self.named_parameters():
            if name.endswith(("pos_embed", "relative_position_bias_table")):
                trunc_normal_(p, 0.02, gen)
        self.to(device).eval()

    def forward(self, x: torch.Tensor):
        x = self.patch_embed(x)
        for level, lb in zip(self.levels, self.blocks_edge):
            if hasattr(level, "pool"):
                x = level.pool(x)
            x = self.pos_drop(blockify(x, lb) + level.pos_embed)
            for layer in level.transformer_encoder:
                x = layer(x)
            x = deblockify(x, lb)
        x = self.norm(x)
        return x, self.pos_drop(x.mean(dim=(1, 2)))


_MICRO = dict(embed_dims=(128, 384, 512), num_heads=(4, 12, 16), depths=(2, 2, 2))
_V2 = dict(embed_dims=(128, 384, 512), num_heads=(16, 24, 32), depths=(2, 2, 2))
_VARIANTS = {
    "nest_nano_80": dict(embed_dims=(96, 192, 384), num_heads=(3, 6, 12), depths=(2, 3, 3)),
    "nest_micro_80": _MICRO,
    "nest_micro_resembed_80": dict(_MICRO, conv_stem=True),
    # the reference's own 2x ctor never passes its downsample=False; the
    # JAX package implements the evident intent, and so does the port
    "nest_micro_resembed_2x_80": dict(_MICRO, conv_stem=True, last_level_2x=True),
    "nest_micro_v2_gpsa": dict(_V2, gpsa_levels=2),
    "nest_micro_v2_rel_80": dict(_V2, rel_bias=True),
    # its 'adapool' is applied nowhere in the reference: the live model is resembed
    "nest_micro_resembed_ada_80": dict(_MICRO, conv_stem=True),
    "nest_12m_v3": dict(embed_dims=(160, 480, 512), num_heads=(16, 24, 32), depths=(1, 1, 2)),
}

for _name, _cfg in _VARIANTS.items():
    models.register(_name)(lambda _cfg=_cfg, **kw: Nest(**{"img_size": 80, **_cfg, **kw}))
