"""Plain PyTorch NesT forward, written from the paper (Zhang et al., "Nested
Hierarchical Transformer: Towards Accurate, Data-Efficient and
Interpretable Visual Understanding", AAAI 2022, arXiv:2105.12723) at the
widths of its NesT-T (the authors' ``nest_tiny_s196_224``), as an encoder:
the final LayerNorm's map and its mean, no classifier.

The equations, with L levels and S = 4^(L - 1) blocks at the first level:

  * patch embedding: 4x4 patches, one linear map of their 48 values to C_1
    (a stride-4 ``F.conv2d``);
  * level l holds T_l = 4^(L - l) non-overlapping square blocks of the
    token map, each of n tokens (14 x 14 = 196 for NesT-T at 224 px):
    blockify (B, H, W, C) -> (B, T, n, C), row-major blocks and tokens;
    then z = z + P_l, P_l a learned (1, T_l, n, C_l) positional embedding;
  * a layer: z' = MSA(LN(z)) + z, z = MLP(LN(z')) + z', the attention
    within each block alone: softmax(q k^T / sqrt(d)) v per head;
  * MLP: Linear(C, 4C), GELU, Linear(4C, C);
  * block aggregation between levels (ConvPool): deblockify to the map, a
    3x3 conv (padding 1) to C_(l+1), LayerNorm over channels, a 3x3 max-pool
    of stride 2 with padding 1, then blockify at the next level's T;
  * the last level: deblockify, LayerNorm, the mean over the map.

Departures from the paper's text, each as the official code has it and the
measured program follows: the heads' outputs merge head-dim-major (the
official code's transpose: channel = d * H + h, not h * d_head + d) before
the output projection; the max-pool pads with -inf; LayerNorm's epsilon is
1e-6; GELU is the exact erf form; drop-path and dropout are off (eval).

Parameters are a flat dict under the module names of the measured
program's state dict (``patch_embed.proj.weight`` OIHW,
``levels.0.pos_embed`` (1, T, n, C),
``levels.1.transformer_encoder.0.attn.qkv.weight`` (3C, C),
``levels.1.pool.conv.weight`` OIHW, ``levels.1.pool.norm.weight``,
``norm.weight`` ...). Input NHWC, every map (B, H, W, C). No kernel, cache
or fused path of the measured program is used.

``quant`` rounds every linear map's and conv's weights (scaled per output
channel) and input (scaled per tensor) before the product, to ``"int8"`` or
``"fp8"`` (e4m3), as ``visformer.Encoder`` does for its convs.
``compute=torch.bfloat16`` runs those products and the attention's two in
bf16 (inputs and weights rounded, results back to fp32).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .visformer import rounded

LN_EPS = 1e-6


def levels(cfg: dict) -> List[Tuple[int, int, int, int, int]]:
    """(blocks an image, block edge, channels, heads, layers) of each level."""
    dims, heads, depths = cfg["embed_dims"], cfg["num_heads"], cfg["depths"]
    n_levels = len(dims)
    grid = int(cfg["img_size"]) // int(cfg["patch_size"])
    edge = grid // 2 ** (n_levels - 1)
    if edge * 2 ** (n_levels - 1) != grid:
        raise ValueError(f"{2 ** (n_levels - 1)} blocks a side do not tile a {grid} grid")
    return [(4 ** (n_levels - 1 - i), edge, int(dims[i]), int(heads[i]), int(depths[i]))
            for i in range(n_levels)]


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the encoder, by name."""
    if cfg.get("conv_stem") or cfg.get("gpsa_levels") or cfg.get("rel_bias") \
            or cfg.get("last_level_2x"):
        raise ValueError("the reference is NesT-T's: patch embed, standard attention, "
                         "every level downsampled")
    p = int(cfg["patch_size"])
    ratio = float(cfg.get("mlp_ratio", 4.0))
    qkv_bias = bool(cfg.get("qkv_bias", True))
    out: Dict[str, Tuple[int, ...]] = {}

    def linear(name, cin, cout, bias=True):
        out[f"{name}.weight"] = (cout, cin)
        if bias:
            out[f"{name}.bias"] = (cout,)

    def norm(name, d):
        out[f"{name}.weight"] = (d,)
        out[f"{name}.bias"] = (d,)

    lv = levels(cfg)
    out["patch_embed.proj.weight"] = (lv[0][2], 3, p, p)
    out["patch_embed.proj.bias"] = (lv[0][2],)
    for i, (t, edge, c, _, depth) in enumerate(lv):
        out[f"levels.{i}.pos_embed"] = (1, t, edge * edge, c)
        if i:
            out[f"levels.{i}.pool.conv.weight"] = (c, lv[i - 1][2], 3, 3)
            out[f"levels.{i}.pool.conv.bias"] = (c,)
            norm(f"levels.{i}.pool.norm", c)
        for j in range(depth):
            b = f"levels.{i}.transformer_encoder.{j}"
            norm(f"{b}.norm1", c)
            linear(f"{b}.attn.qkv", c, 3 * c, qkv_bias)
            linear(f"{b}.attn.proj", c, c)
            norm(f"{b}.norm2", c)
            linear(f"{b}.mlp.fc1", c, int(c * ratio))
            linear(f"{b}.mlp.fc2", int(c * ratio), c)
    norm("norm", lv[-1][2])
    return out


def blockify(x: torch.Tensor, edge: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, T, edge^2, C): blocks and their tokens row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // edge, edge, w // edge, edge, c).transpose(2, 3)
    return x.reshape(b, (h // edge) * (w // edge), edge * edge, c)


def deblockify(x: torch.Tensor, edge: int) -> torch.Tensor:
    """The inverse of ``blockify`` for a square map."""
    b, t, _, c = x.shape
    g = math.isqrt(t)
    x = x.reshape(b, g, g, edge, edge, c).transpose(2, 3)
    return x.reshape(b, g * edge, g * edge, c)


class Encoder:
    """``Encoder(params, cfg)(x NHWC) -> (dense NHWC, pooled)``."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, quant: Optional[str] = None,
                 compute: torch.dtype = torch.float32):
        self.p, self.cfg, self.quant, self.compute = params, cfg, quant, compute
        self.levels = levels(cfg)

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w, b = self.p[f"{name}.weight"], self.p.get(f"{name}.bias")
        if self.quant:
            x, w = rounded(x, self.quant), rounded(w, self.quant, dims=(1,))
        if self.compute != torch.float32:
            c = self.compute
            return F.linear(x.to(c), w.to(c), None if b is None else b.to(c)).float()
        return F.linear(x, w, b)

    def conv(self, x: torch.Tensor, name: str, stride: int, padding: int) -> torch.Tensor:
        """NHWC in and out."""
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        x = x.permute(0, 3, 1, 2)
        if self.quant:
            x, w = rounded(x, self.quant), rounded(w, self.quant, dims=(1, 2, 3))
        if self.compute != torch.float32:
            c = self.compute
            y = F.conv2d(x.to(c), w.to(c), b.to(c), stride, padding).float()
        else:
            y = F.conv2d(x, w, b, stride, padding)
        return y.permute(0, 2, 3, 1)

    def product(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        c = self.compute
        return torch.einsum(eq, a.to(c), b.to(c)).float()

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                            LN_EPS)

    def attention(self, x: torch.Tensor, name: str, heads: int) -> torch.Tensor:
        """MSA within each block of (B, T, n, C)."""
        b, t, n, c = x.shape
        d = c // heads
        qkv = self.linear(x, f"{name}.qkv").reshape(b, t, n, 3, heads, d)
        q, k, v = qkv.unbind(3)  # (B, T, n, heads, d)
        logits = self.product("btqhd,btkhd->bthqk", q, k) / math.sqrt(d)
        attn = torch.softmax(logits, dim=-1)
        o = self.product("bthqk,btkhd->btqdh", attn, v)  # channel = d * heads + h
        return self.linear(o.reshape(b, t, n, c), f"{name}.proj")

    def pool(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = self.norm(self.conv(x, f"{name}.conv", 1, 1), f"{name}.norm")
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1)  # pads with -inf
        return y.permute(0, 2, 3, 1)

    def __call__(self, x_nhwc: torch.Tensor):
        x = self.conv(x_nhwc, "patch_embed.proj", int(self.cfg["patch_size"]), 0)
        for i, (_, edge, _, heads, depth) in enumerate(self.levels):
            if i:
                x = self.pool(x, f"levels.{i}.pool")
            z = blockify(x, edge) + self.p[f"levels.{i}.pos_embed"]
            for j in range(depth):
                lyr = f"levels.{i}.transformer_encoder.{j}"
                z = z + self.attention(self.norm(z, f"{lyr}.norm1"), f"{lyr}.attn", heads)
                h = F.gelu(self.linear(self.norm(z, f"{lyr}.norm2"), f"{lyr}.mlp.fc1"))
                z = z + self.linear(h, f"{lyr}.mlp.fc2")
            x = deblockify(z, edge)
        x = self.norm(x, "norm")
        return x, x.mean(dim=(1, 2))
