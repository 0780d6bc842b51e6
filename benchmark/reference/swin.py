"""Plain PyTorch Swin Transformer forward, written from the paper (Liu et
al., "Swin Transformer: Hierarchical Vision Transformer using Shifted
Windows", ICCV 2021, arXiv:2103.14030) at the widths of its Swin-T
(``configs/swin/swin_tiny_patch4_window7_224.yaml``), as an encoder: the
final LayerNorm's tokens and their mean, no classifier.

The equations, with M the window edge and s = floor(M / 2):

  * patch partition and linear embedding: 4x4 patches, one linear map of
    their 48 values to C (a stride-4 ``F.conv2d``), then LayerNorm;
  * a block: z' = W-MSA(LN(z)) + z, z = MLP(LN(z')) + z'; odd blocks use
    SW-MSA: the grid rolled by (-s, -s) before the window partition and
    rolled back after, attention masked between tokens that came from
    different regions of the unrolled grid;
  * attention in each M x M window and head: softmax(q k^T / sqrt(d) + B) v,
    B[i, j] = Bhat[dy + M - 1, dx + M - 1] for the offset (dy, dx) of token
    i from token j, Bhat a learned (2M - 1)^2 table per head;
  * MLP: Linear(C, 4C), GELU, Linear(4C, C);
  * patch merging between stages: the 2 x 2 neighbours' features
    concatenated (4C), LayerNorm, a linear map to 2C without bias.

Departures from the paper's text, each as the official code has it: the
mask adds -100 to the masked logits rather than -inf; a stage whose grid is
no larger than M (Swin-T's last, 7 x 7) is one window, unshifted; the
neighbours are concatenated in the order (even row, even col), (odd, even),
(even, odd), (odd, odd); LayerNorm's epsilon is 1e-5; GELU is the exact
erf form; drop-path and dropout are off (eval).

Parameters are a flat dict under the module names of the measured
program's state dict (``patch_embed.proj.weight`` OIHW,
``layers.0.blocks.1.attn.relative_position_bias_table`` ((2M - 1)^2,
heads), ``layers.0.downsample.reduction.weight`` ...). Input NHWC, every
layer on (B, H, W, C) maps. No kernel, cache or fused path of the measured
program is used.

``quant`` rounds every linear map's and the patch conv's weights (scaled
per output channel) and input (scaled per tensor) before the product, to
``"int8"`` or ``"fp8"`` (e4m3), as ``visformer.Encoder`` does for its convs.
``compute=torch.bfloat16`` runs those products and the attention's two in
bf16 (inputs and weights rounded, results back to fp32).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .visformer import rounded

LN_EPS = 1e-5
MASKED = -100.0


def stage_grids(cfg: dict):
    """(grid edge, window edge, shift of odd blocks) of each stage."""
    r = int(cfg["img_size"]) // int(cfg["patch_size"])
    m = int(cfg["window_size"])
    out = []
    for _ in cfg["depths"]:
        w = min(m, r)
        if r % w:
            raise ValueError(f"window {w} does not tile a {r} x {r} grid")
        out.append((r, w, w // 2 if r > m else 0))
        r //= 2
    return out


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the encoder, by name."""
    if cfg.get("ape", False) or not cfg.get("patch_norm", True):
        raise ValueError("the reference is Swin-T's: no absolute position embedding, "
                         "patch norm on")
    c, p = int(cfg["embed_dim"]), int(cfg["patch_size"])
    hidden = lambda d: int(d * float(cfg.get("mlp_ratio", 4.0)))
    qkv_bias = bool(cfg.get("qkv_bias", True))
    out: Dict[str, Tuple[int, ...]] = {}

    def linear(name, cin, cout, bias=True):
        out[f"{name}.weight"] = (cout, cin)
        if bias:
            out[f"{name}.bias"] = (cout,)

    def norm(name, d):
        out[f"{name}.weight"] = (d,)
        out[f"{name}.bias"] = (d,)

    out["patch_embed.proj.weight"] = (c, 3, p, p)
    out["patch_embed.proj.bias"] = (c,)
    norm("patch_embed.norm", c)
    grids = stage_grids(cfg)
    for i, (n_blocks, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        d = c * 2 ** i
        m = grids[i][1]
        for j in range(int(n_blocks)):
            b = f"layers.{i}.blocks.{j}"
            norm(f"{b}.norm1", d)
            linear(f"{b}.attn.qkv", d, 3 * d, qkv_bias)
            out[f"{b}.attn.relative_position_bias_table"] = ((2 * m - 1) ** 2, int(heads))
            linear(f"{b}.attn.proj", d, d)
            norm(f"{b}.norm2", d)
            linear(f"{b}.mlp.fc1", d, hidden(d))
            linear(f"{b}.mlp.fc2", hidden(d), d)
        if i < len(cfg["depths"]) - 1:
            norm(f"layers.{i}.downsample.norm", 4 * d)
            linear(f"layers.{i}.downsample.reduction", 4 * d, 2 * d, bias=False)
    norm("norm", c * 2 ** (len(cfg["depths"]) - 1))
    return out


def relative_index(m: int) -> torch.Tensor:
    """(m^2, m^2) int64: the row of Bhat for each (query, key) pair of a
    window, tokens in row-major order."""
    ys, xs = torch.meshgrid(torch.arange(m), torch.arange(m), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = ys[:, None] - ys[None, :] + m - 1
    dx = xs[:, None] - xs[None, :] + m - 1
    return dy * (2 * m - 1) + dx


def windows(x: torch.Tensor, m: int) -> torch.Tensor:
    """(B, H, W, ...) -> (B, H/m * W/m, m * m, ...), windows row-major."""
    b, h, w = x.shape[:3]
    rest = x.shape[3:]
    x = x.reshape(b, h // m, m, w // m, m, *rest).transpose(2, 3)
    return x.reshape(b, (h // m) * (w // m), m * m, *rest)


def unwindows(x: torch.Tensor, m: int, h: int, w: int) -> torch.Tensor:
    """The inverse of ``windows``."""
    b, rest = x.shape[0], x.shape[3:]
    x = x.reshape(b, h // m, w // m, m, m, *rest).transpose(2, 3)
    return x.reshape(b, h, w, *rest)


def shift_mask(r: int, m: int, s: int, device) -> torch.Tensor:
    """(r/m * r/m, m^2, m^2) additive mask of the shifted grid: each token
    of the grid rolled by (-s, -s) is labelled by the region it came from
    (rows and columns [0, r - m), [r - m, r - s), [r - s, r) of the rolled
    grid), and a pair with different labels gets ``MASKED``."""
    i = torch.arange(r, device=device)
    region = (i >= r - m).long() + (i >= r - s).long()
    label = (3 * region[:, None] + region[None, :])[None]  # (1, r, r)
    lw = windows(label, m)[0]  # (nW, m^2)
    return torch.where(lw[:, :, None] != lw[:, None, :], MASKED, 0.0)


class Encoder:
    """``Encoder(params, cfg)(x NHWC) -> (dense NHWC, pooled)``."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, quant: Optional[str] = None,
                 compute: torch.dtype = torch.float32):
        self.p, self.cfg, self.quant, self.compute = params, cfg, quant, compute
        self.grids = stage_grids(cfg)

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w, b = self.p[f"{name}.weight"], self.p.get(f"{name}.bias")
        if self.quant:
            x, w = rounded(x, self.quant), rounded(w, self.quant, dims=(1,))
        if self.compute != torch.float32:
            c = self.compute
            return F.linear(x.to(c), w.to(c), None if b is None else b.to(c)).float()
        return F.linear(x, w, b)

    def product(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        c = self.compute
        return torch.einsum(eq, a.to(c), b.to(c)).float()

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                            LN_EPS)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.p["patch_embed.proj.weight"], self.p["patch_embed.proj.bias"]
        x = x.permute(0, 3, 1, 2)
        if self.quant:
            x, w = rounded(x, self.quant), rounded(w, self.quant, dims=(1, 2, 3))
        p = int(self.cfg["patch_size"])
        if self.compute != torch.float32:
            c = self.compute
            y = F.conv2d(x.to(c), w.to(c), b.to(c), stride=p).float()
        else:
            y = F.conv2d(x, w, b, stride=p)
        return self.norm(y.permute(0, 2, 3, 1), "patch_embed.norm")

    def attention(self, x: torch.Tensor, name: str, m: int, s: int, heads: int) -> torch.Tensor:
        """(W-)MSA over the (B, r, r, C) map ``x``, shifted by ``s``."""
        b, r, _, c = x.shape
        d = c // heads
        if s:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
        qkv = self.linear(windows(x, m), f"{name}.qkv").reshape(b, -1, m * m, 3, heads, d)
        q, k, v = qkv.unbind(3)  # (B, nW, m^2, heads, d)
        logits = self.product("bwqhd,bwkhd->bwhqk", q, k) / math.sqrt(d)
        table = self.p[f"{name}.relative_position_bias_table"]  # ((2m-1)^2, heads)
        bias = table[relative_index(m).to(table.device)]  # (m^2, m^2, heads)
        logits = logits + bias.permute(2, 0, 1)
        if s:
            logits = logits + shift_mask(r, m, s, x.device)[None, :, None]
        attn = torch.softmax(logits, dim=-1)
        o = self.product("bwhqk,bwkhd->bwqhd", attn, v).reshape(b, -1, m * m, c)
        y = unwindows(self.linear(o, f"{name}.proj"), m, r, r)
        return torch.roll(y, (s, s), dims=(1, 2)) if s else y

    def merge(self, x: torch.Tensor, name: str) -> torch.Tensor:
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.linear(self.norm(x, f"{name}.norm"), f"{name}.reduction")

    def __call__(self, x_nhwc: torch.Tensor):
        x = self.embed(x_nhwc)
        for i, (n_blocks, heads) in enumerate(zip(self.cfg["depths"], self.cfg["num_heads"])):
            if i:
                x = self.merge(x, f"layers.{i - 1}.downsample")
            r, m, shift = self.grids[i]
            for j in range(int(n_blocks)):
                blk = f"layers.{i}.blocks.{j}"
                x = x + self.attention(self.norm(x, f"{blk}.norm1"), f"{blk}.attn", m,
                                       shift if j % 2 else 0, int(heads))
                h = F.gelu(self.linear(self.norm(x, f"{blk}.norm2"), f"{blk}.mlp.fc1"))
                x = x + self.linear(h, f"{blk}.mlp.fc2")
        x = self.norm(x, "norm")
        return x, x.mean(dim=(1, 2))
