"""DeiT / plain ViT with a cls token (counterpart: ``fewshot_vit_tpu/models/deit.py``).

Pre-LN blocks (LayerNorm eps 1e-6, qkv with bias), a cls token and a learned
(N + 1)-token positional embedding; forward: NHWC (B, H, W, 3) -> (the normed
patch tokens as a (B, g, g, C) map, the cls token). State-dict keys are the
reference's (``patch_embed.proj``, ``blocks.3.attn.qkv``, ``blocks.3.mlp.fc1``,
``cls_token``), the keys ``checkpoint/from_flax.py::deit_key`` gives.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.registry import models
from .common import Conv, DropPath, Dropout, LayerNorm, Linear, init_weights, trunc_normal_
from .swin import Mlp
from .visformer import drop_path_ladder


class ViTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, qkv_bias, dtype)
        self.proj = Linear(dim, dim, True, dtype)
        self.attn_drop, self.proj_drop = Dropout(attn_drop), Dropout(proj_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k, v = self.qkv(x).reshape(b, n, 3, h, hd).unbind(2)
        attn = self.attn_drop(torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5,
                                            dim=-1))
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, c)
        return self.proj_drop(self.proj(out))


class ViTBlock(nn.Module):
    """Pre-LN block; each residual branch is divided by ``skip_lam`` (1 for
    DeiT, 2 for LV-ViT)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0,
                 eps: float = 1e-6, skip_lam: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps, dtype)
        self.attn = ViTAttention(dim, num_heads, qkv_bias, attn_drop, drop, dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, dtype)
        self.skip_lam = skip_lam

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x))) / self.skip_lam
        return x + self.drop_path(self.mlp(self.norm2(x))) / self.skip_lam


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv(3, dim, patch, patch, 0, bias=True, dtype=dtype, init="trunc")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class TokenViT(nn.Module):
    """What DeiT and LV-ViT share after the patch embed: the cls token, the
    positional embedding, the blocks, the final norm and the
    ``(patch map, cls)`` output."""

    def _build_tokens(self, n: int, embed_dim: int, depth: int, num_heads: int,
                      mlp_ratio: float, qkv_bias: bool, drop_rate: float,
                      attn_drop_rate: float, drop_path_rate: float, eps: float,
                      skip_lam: float, dtype: torch.dtype) -> None:
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim))
        self.pos_drop = Dropout(drop_rate)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate, attn_drop_rate, r,
                     eps, skip_lam, dtype)
            for r in drop_path_ladder(drop_path_rate, depth))
        self.norm = LayerNorm(embed_dim, eps, dtype)

    def _init(self, seed: int, device) -> None:
        gen = torch.Generator().manual_seed(seed)
        init_weights(self, gen)
        trunc_normal_(self.cls_token, 0.02, gen)
        trunc_normal_(self.pos_embed, 0.02, gen)
        self.to(device).eval()

    def forward(self, x: torch.Tensor):
        x = self.patch_embed(x)
        b, g, _, c = x.shape
        # an fp32 cls token promotes the tokens to fp32, as jnp.concatenate does
        x = torch.cat([self.cls_token.expand(b, 1, c), x.reshape(b, g * g, c)], dim=1)
        x = self.pos_drop(x + self.pos_embed)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 1:].reshape(b, g, g, c), x[:, 0]


class VisionTransformer(TokenViT):
    """``forward -> (patch map, cls)``; ``dtype`` is the compute dtype,
    parameters stay fp32, weights drawn on the CPU from ``seed``."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 device: Any = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.out_dim = embed_dim
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        g = img_size // patch_size
        self._build_tokens(g * g, embed_dim, depth, num_heads, mlp_ratio, qkv_bias, drop_rate,
                           attn_drop_rate, drop_path_rate, 1e-6, 1.0, dtype)
        self._init(seed, device)


_VARIANTS = {
    "deit_tiny_patch16_224": dict(patch_size=16, embed_dim=192, depth=12, num_heads=3),
    "deit_small_patch16_224": dict(patch_size=16, embed_dim=384, depth=12, num_heads=6),
    "deit_base_patch16_224": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12),
    "deit_nano_patch16_224": dict(patch_size=16, embed_dim=224, depth=12, num_heads=4),
    "deit_nano_patch6_84": dict(img_size=84, patch_size=6, embed_dim=224, depth=12, num_heads=4),
    "deit_micro_patch6_84": dict(img_size=84, patch_size=6, embed_dim=272, depth=12, num_heads=4),
}

for _name, _cfg in _VARIANTS.items():
    models.register(_name)(lambda _cfg=_cfg, **kw: VisionTransformer(**{**_cfg, **kw}))
