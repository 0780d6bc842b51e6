"""Plain PyTorch LeViT forward, written from the paper (Graham et al.,
"LeViT: a Vision Transformer in ConvNet's Clothing for Faster Inference",
ICCV 2021, arXiv:2104.01136) at the widths of SUN's ``levit_micro_80``
(Dong et al., ECCV 2022, ``sun_meta_training/models/levit.py``), as an
encoder: the last stage's tokens and their mean, no classifier.

The equations, with stages s = 1..3 of width C_s, h_s heads, key width kd
and value width d_s = attn_ratio * kd:

  * every "LinearNorm" is a bias-free linear map followed by a BatchNorm
    whose statistics run over the batch and the tokens together;
  * attention over the N = r x r tokens of a stage: per head, the channels
    of qkv = LN(x) split as (q, k, v) of widths (kd, kd, d_s); the score of
    query i and key j is q_i . k_j / sqrt(kd) + B[h, idx(i, j)], where B is
    a learned (heads, offsets) table and idx indexes the offset
    (|y_i - y_j|, |x_i - x_j|) between the two grid points; softmax over j,
    o = p v, then hard-swish and the LinearNorm ``proj``;
  * a block: x = x + Attention(x), x = x + MLP(x), the MLP LinearNorm(C,
    mlp_ratio C), hard-swish, LinearNorm(mlp_ratio C, C);
  * between stages, attention with subsampled queries (no residual): k, v
    from LN(x) over the r x r grid at widths (kd, 4 kd) and C_s / kd heads,
    q from LN of the tokens at stride 2 (an r' x r' grid, r' = (r - 1) // 2
    + 1), the offset of query (y, x) and key (y', x') taken as (|2 y - y'|,
    |2 x - x'|), the projection to C_(s+1); then x = x + MLP(x) at ratio 2;
  * the pooled output is the mean over the last stage's tokens.

Offsets are numbered as the official code numbers them, in the order of
their first appearance over the query rows and key columns. The first query
sits at (0, 0) and already meets every offset, so offset (dy, dx) has index
dy * r + dx for a key grid of edge r, at either stride.

Departures from the paper, each as SUN's code has it and the measured
program follows: the patch embedding is Visformer's residual 3-conv stem at
stride 4 (conv3x3/s2, BN, leaky ReLU 0.1, conv3x3, BN, leaky ReLU, conv3x3,
BN, plus a conv3x3/s2 + BN shortcut, leaky ReLU, 2x2 max-pool) in place of
LeViT's four stride-2 convs; the depths are 1 / 2 / 3 in place of
LeViT-256's 4 / 4 / 4; no distillation head and no classifier; drop-path
off (eval). BN's epsilon is 1e-5.

Parameters are a flat dict under the module names of the measured
program's state dict (``patch_embed.conv1.weight`` OIHW,
``patch_embed.bn1.running_var``, ``blocks.0.m.qkv.c.weight`` (out, in),
``blocks.0.m.attention_biases`` (heads, offsets), ``blocks.2.kv.c.weight``,
``blocks.2.q.1.bn.weight``, ``blocks.1.m.2.c.weight`` ...). Input NHWC. No
kernel, cache, fold or fused path of the measured program is used.

``bn``: ``"running"`` normalizes with the running statistics (eval);
``"batch"`` with the batch's biased statistics, which it writes into
``stats`` (the harness's calibration of the running statistics).
``quant`` rounds every linear map's and conv's weights (scaled per output
channel) and input (scaled per tensor) before the product, to ``"int8"`` or
``"fp8"`` (e4m3), as ``visformer.Encoder`` does for its convs.
``compute=torch.bfloat16`` runs those products and the attention's two in
bf16 (inputs and weights rounded, results back to fp32).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .visformer import BN_EPS, rounded

# the subsampling attention between stages, as SUN's down_ops give it:
# C_s / kd heads, value width 4 kd, MLP ratio 2 after it, stride 2
DOWN_ATTN_RATIO, DOWN_MLP_RATIO, DOWN_STRIDE = 4, 2, 2
STEM_STRIDE = 4


class Attn(NamedTuple):
    """One attention call: its module name, input and output widths, heads,
    key and value widths, the key grid's edge, the query grid's edge and
    the stride between them."""
    name: str
    cin: int
    cout: int
    heads: int
    kd: int
    d: int
    res_kv: int
    res_q: int
    stride: int


def layout(cfg: dict) -> List[Tuple[str, object]]:
    """The blocks in order, as (kind, what): ``("attn", Attn)`` a residual
    attention, ``("mlp", (name, C, hidden))`` a residual MLP, ``("down",
    Attn)`` a subsampling attention (no residual)."""
    dims = [int(c) for c in cfg["embed_dim"]]
    heads = [int(h) for h in cfg["num_heads"]]
    depth = [int(n) for n in cfg["depth"]]
    kd, ratio = int(cfg["key_dim"]), int(cfg["attn_ratio"])
    mlp_ratio = int(cfg["mlp_ratio"])
    res = int(cfg["img_size"]) // STEM_STRIDE
    out: List[Tuple[str, object]] = []
    for s, c in enumerate(dims):
        for _ in range(depth[s]):
            out.append(("attn", Attn(f"blocks.{len(out)}.m", c, c, heads[s], kd, ratio * kd,
                                     res, res, 1)))
            out.append(("mlp", (f"blocks.{len(out)}.m", c, c * mlp_ratio)))
        if s < len(dims) - 1:
            res_q = (res - 1) // DOWN_STRIDE + 1
            out.append(("down", Attn(f"blocks.{len(out)}", c, dims[s + 1], c // kd, kd,
                                     DOWN_ATTN_RATIO * kd, res, res_q, DOWN_STRIDE)))
            out.append(("mlp", (f"blocks.{len(out)}.m", dims[s + 1],
                                dims[s + 1] * DOWN_MLP_RATIO)))
            res = res_q
    return out


def attentions(cfg: dict) -> List[Attn]:
    """Every attention call of a forward, in order."""
    return [a for kind, a in layout(cfg) if kind != "mlp"]


def scores_per_image(cfg: dict) -> int:
    """Attention scores an image: heads x queries x keys over every call."""
    return sum(a.heads * a.res_q ** 2 * a.res_kv ** 2 for a in attentions(cfg))


def bias_index(res_q: int, res_kv: int, stride: int, device=None) -> torch.Tensor:
    """(Nq, Nkv) index into a (heads, res_kv^2) bias table: query (y, x) of
    the res_q grid and key (y', x') of the res_kv grid meet at offset
    (|stride y - y'|, |stride x - x'|), numbered dy * res_kv + dx."""
    q = torch.arange(res_q, device=device) * stride
    k = torch.arange(res_kv, device=device)
    dy = (q[:, None] - k[None, :]).abs()  # (res_q, res_kv)
    idx = dy[:, None, :, None] * res_kv + dy[None, :, None, :]
    return idx.reshape(res_q * res_q, res_kv * res_kv)


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and BN statistic of the encoder, by name."""
    out: Dict[str, Tuple[int, ...]] = {}

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{leaf}"] = (c,)

    def linear_norm(name, cin, cout):
        out[f"{name}.c.weight"] = (cout, cin)
        bn(f"{name}.bn", cout)

    hidden, c0 = int(cfg["stem_hidden"]), int(cfg["embed_dim"][0])
    out["patch_embed.conv1.weight"] = (hidden, 3, 3, 3)
    bn("patch_embed.bn1", hidden)
    out["patch_embed.conv2.weight"] = (c0, hidden, 3, 3)
    bn("patch_embed.bn2", c0)
    out["patch_embed.conv3.weight"] = (c0, c0, 3, 3)
    bn("patch_embed.bn3", c0)
    out["patch_embed.downsample.0.weight"] = (c0, 3, 3, 3)
    bn("patch_embed.downsample.1", c0)
    for kind, a in layout(cfg):
        if kind == "mlp":
            name, c, h = a
            linear_norm(f"{name}.0", c, h)
            linear_norm(f"{name}.2", h, c)
            continue
        out[f"{a.name}.attention_biases"] = (a.heads, a.res_kv ** 2)
        if kind == "attn":
            linear_norm(f"{a.name}.qkv", a.cin, a.heads * (2 * a.kd + a.d))
        else:
            linear_norm(f"{a.name}.kv", a.cin, a.heads * (a.kd + a.d))
            linear_norm(f"{a.name}.q.1", a.cin, a.heads * a.kd)
        linear_norm(f"{a.name}.proj.1", a.heads * a.d, a.cout)
    return out


class Encoder:
    """``Encoder(params, cfg)(x NHWC) -> (dense NHWC, pooled)``."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, bn: str = "running",
                 quant: Optional[str] = None, compute: torch.dtype = torch.float32):
        self.p, self.cfg, self.bn_mode, self.quant = params, cfg, bn, quant
        self.compute = compute
        self.stats: Dict[str, torch.Tensor] = {}
        self.blocks = layout(cfg)

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """BatchNorm over the last axis, statistics over every other."""
        g, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        if self.bn_mode == "batch":
            dims = tuple(range(x.dim() - 1))
            mean, var = x.mean(dim=dims), x.var(dim=dims, unbiased=False)
            self.stats[f"{name}.running_mean"] = mean.detach()
            self.stats[f"{name}.running_var"] = var.detach()
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        return (x - mean) * (g / torch.sqrt(var + BN_EPS)) + b

    def conv(self, x: torch.Tensor, name: str, stride: int) -> torch.Tensor:
        """A bias-free 3x3 conv with padding 1, NHWC in and out."""
        w = self.p[f"{name}.weight"]
        x = x.permute(0, 3, 1, 2)
        if self.quant:
            x, w = rounded(x, self.quant), rounded(w, self.quant, dims=(1, 2, 3))
        c = self.compute
        y = F.conv2d(x.to(c), w.to(c), None, stride, 1).float()
        return y.permute(0, 2, 3, 1)

    def linear_norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w = self.p[f"{name}.c.weight"]
        if self.quant:
            x, w = rounded(x, self.quant), rounded(w, self.quant, dims=(1,))
        c = self.compute
        return self.norm(F.linear(x.to(c), w.to(c)).float(), f"{name}.bn")

    def product(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        c = self.compute
        return torch.einsum(eq, a.to(c), b.to(c)).float()

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        lrelu = lambda t: F.leaky_relu(t, 0.1)
        y = lrelu(self.norm(self.conv(x, "patch_embed.conv1", 2), "patch_embed.bn1"))
        y = lrelu(self.norm(self.conv(y, "patch_embed.conv2", 1), "patch_embed.bn2"))
        y = self.norm(self.conv(y, "patch_embed.conv3", 1), "patch_embed.bn3")
        ds = self.norm(self.conv(x, "patch_embed.downsample.0", 2), "patch_embed.downsample.1")
        y = F.max_pool2d(lrelu(y + ds).permute(0, 3, 1, 2), 2, 2)
        return y.permute(0, 2, 3, 1)

    def attention(self, x: torch.Tensor, a: Attn, subsample: bool) -> torch.Tensor:
        """(B, res_kv^2, C_in) -> (B, res_q^2, C_out)."""
        b, n, _ = x.shape
        h, kd, d = a.heads, a.kd, a.d
        if subsample:
            k, v = self.linear_norm(x, f"{a.name}.kv").reshape(b, n, h, kd + d).split([kd, d], -1)
            xq = x.reshape(b, a.res_kv, a.res_kv, -1)[:, ::a.stride, ::a.stride]
            q = self.linear_norm(xq.reshape(b, a.res_q ** 2, -1), f"{a.name}.q.1")
            q = q.reshape(b, a.res_q ** 2, h, kd)
        else:
            q, k, v = self.linear_norm(x, f"{a.name}.qkv").reshape(b, n, h, 2 * kd + d).split(
                [kd, kd, d], -1)
        table = self.p[f"{a.name}.attention_biases"]
        bias = table[:, bias_index(a.res_q, a.res_kv, a.stride, table.device)]  # (h, Nq, Nkv)
        scores = self.product("bqhd,bkhd->bhqk", q, k) / math.sqrt(kd) + bias
        o = self.product("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
        return self.linear_norm(F.hardswish(o.reshape(b, o.shape[1], h * d)), f"{a.name}.proj.1")

    def mlp(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.linear_norm(F.hardswish(self.linear_norm(x, f"{name}.0")), f"{name}.2")

    def __call__(self, x_nhwc: torch.Tensor):
        x = self.stem(x_nhwc)
        b, r, _, c = x.shape
        x = x.reshape(b, r * r, c)
        for kind, a in self.blocks:
            if kind == "attn":
                x = x + self.attention(x, a, False)
            elif kind == "down":
                x = self.attention(x, a, True)
                r = a.res_q
            else:
                x = x + self.mlp(x, a[0])
        return x.reshape(b, r, r, -1), x.mean(dim=1)
