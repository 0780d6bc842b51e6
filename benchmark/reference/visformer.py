"""Plain PyTorch Visformer forward, written from the published architecture
(Chen et al., "Visformer: The Vision-friendly Transformer", ICCV 2021) as
the SUN code base instantiates it for 80 px images.

Parameters are a flat dict of tensors under the published module names
(``stem.conv1.weight``, ``stage2.0.attn.qkv.weight``, ``norm.bn.running_var``
...). Activations are NCHW inside and NHWC at the edges; every conv is
``F.conv2d`` and attention is an explicit softmax(q k^T / sqrt(d)) v. No
kernel, cache or fused path of the measured program is used.

``bn``: ``"running"`` normalizes with the running statistics (eval);
``"batch"`` with the batch's biased statistics, which it writes into
``stats`` (the train-mode forward, and the harness's calibration of the
running statistics). ``quant`` rounds every conv's weights (scaled per
output channel) and input (scaled per tensor) before the product, to
symmetric ``"int8"`` or to ``"fp8"`` (e4m3, the largest magnitude at 448):
the lower-precision controls of a bf16 configuration. ``compute=torch.bfloat16``
runs every conv and the attention's two products in bf16 (inputs and
weights rounded, results back to fp32): the yardstick of bf16 rounding
alone. ``drop_path(x, rate)`` is called at every residual branch in block
order when given.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def widths(cfg: dict) -> Tuple[int, int, int]:
    e = int(cfg["embed_dim"])
    return e // 2, e, 2 * e


def head_dim(dim: int, heads: int, ratio: float) -> int:
    return round(dim // heads * ratio)


def _hidden(dim: int, spatial: bool, group: int, mlp_ratio: float) -> int:
    if spatial:
        return dim * 5 // 6 if group < 2 else dim * 2
    return int(dim * mlp_ratio)


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and BN statistic of the encoder, by name."""
    d1, d2, d3 = widths(cfg)
    dims = (d1, d2, d3)
    c0 = int(cfg["init_channels"])
    heads, group = int(cfg["num_heads"]), int(cfg["group"])
    mlp_ratio = float(cfg.get("mlp_ratio", 4.0))
    size = int(cfg["img_size"]) // 4
    out: Dict[str, Tuple[int, ...]] = {}

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{leaf}"] = (c,)

    out["stem.conv1.weight"] = (c0, 3, 3, 3)
    bn("stem.bn1", c0)
    out["stem.conv2.weight"] = (d1, c0, 3, 3)
    bn("stem.bn2", d1)
    out["stem.conv3.weight"] = (d1, d1, 3, 3)
    bn("stem.bn3", d1)
    out["stem.downsample.0.weight"] = (d1, 3, 3, 3)
    bn("stem.downsample.1", d1)
    sizes = (size, size // 2, size // 4)
    for s, (n_blocks, dim) in enumerate(zip(cfg["depth"], dims), start=1):
        if s > 1:
            out[f"patch_embed{s}.proj.weight"] = (dim, dims[s - 2], 2, 2)
            out[f"patch_embed{s}.proj.bias"] = (dim,)
            bn(f"patch_embed{s}.norm.bn", dim)
        out[f"pos_embed{s}"] = (1, dim, sizes[s - 1], sizes[s - 1])
        for i in range(int(n_blocks)):
            p = f"stage{s}.{i}"
            if cfg["attn_stage"][s - 1] == "1":
                hd = head_dim(dim, heads, 0.5 if s == 1 else 1.0)
                bn(f"{p}.norm1.bn", dim)
                out[f"{p}.attn.qkv.weight"] = (3 * heads * hd, dim, 1, 1)
                out[f"{p}.attn.proj.weight"] = (dim, heads * hd, 1, 1)
            bn(f"{p}.norm2.bn", dim)
            spatial = cfg["spatial_conv"][s - 1] == "1"
            hidden = _hidden(dim, spatial, group, mlp_ratio)
            out[f"{p}.mlp.conv1.weight"] = (hidden, dim, 1, 1)
            if spatial:  # the grouped 3x3
                out[f"{p}.mlp.conv2.weight"] = (hidden, hidden // group, 3, 3)
            out[f"{p}.mlp.conv3.weight"] = (dim, hidden, 1, 1)
    bn("norm.bn", d3)
    return out


def rounded(x: torch.Tensor, quant: str, dims=None) -> torch.Tensor:
    """``x`` rounded to ``quant`` ("int8" or "fp8") with the scale of its
    largest magnitude, per tensor (``dims`` None) or over ``dims``."""
    a = x.abs().amax() if dims is None else x.abs().amax(dim=dims, keepdim=True)
    if quant == "int8":
        s = torch.clamp(a / 127.0, min=1e-12)
        return torch.clamp(torch.round(x / s), -127, 127) * s
    s = torch.clamp(a / 448.0, min=1e-12)
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class Encoder:
    """``Encoder(params, cfg)(x NHWC) -> (dense NHWC, pooled)``."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, bn: str = "running",
                 quant: Optional[str] = None,
                 drop_path: Optional[Callable[[torch.Tensor, float], torch.Tensor]] = None,
                 compute: torch.dtype = torch.float32):
        self.p, self.cfg, self.bn_mode, self.quant = params, cfg, bn, quant
        self.compute = compute
        self.drop_path = drop_path
        self.stats: Dict[str, torch.Tensor] = {}
        self.heads = int(cfg["num_heads"])
        depth = [int(d) for d in cfg["depth"]]
        total = sum(depth)
        rate = float(cfg.get("drop_path_rate", 0.0))
        self.rates = [rate * i / max(total - 1, 1) for i in range(total)]

    def conv(self, x, name, stride=1, padding=0, groups=1):
        w = self.p[f"{name}.weight"]
        b = self.p.get(f"{name}.bias")
        if self.quant:
            x, w = rounded(x, self.quant), rounded(w, self.quant, dims=(1, 2, 3))
        if self.compute != torch.float32:
            c = self.compute
            b = None if b is None else b.to(c)
            return F.conv2d(x.to(c), w.to(c), b, stride, padding, 1, groups).float()
        return F.conv2d(x, w, b, stride, padding, 1, groups)

    def product(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        c = self.compute
        return torch.einsum(eq, a.to(c), b.to(c)).float()

    def norm(self, x, name):
        g, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        if self.bn_mode == "batch":
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            self.stats[f"{name}.running_mean"] = mean.detach()
            self.stats[f"{name}.running_var"] = var.detach()
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        scale = g / torch.sqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] + b[:, None, None]

    def branch(self, y, i):
        if self.drop_path is None or self.rates[i] == 0.0:
            return y
        return self.drop_path(y, self.rates[i])

    def attention(self, x, p):
        b, c, h, w = x.shape
        qkv = self.conv(x, f"{p}.qkv").reshape(b, 3, self.heads, -1, h * w)
        q, k, v = qkv.unbind(1)  # (B, heads, hd, T)
        hd = q.shape[2]
        attn = torch.softmax(self.product("bhdq,bhdk->bhqk", q, k) / math.sqrt(hd), dim=-1)
        out = self.product("bhqk,bhdk->bhdq", attn, v).reshape(b, -1, h, w)
        return self.conv(out, f"{p}.proj")

    def mlp(self, x, p, spatial):
        x = F.gelu(self.conv(x, f"{p}.conv1"))
        if spatial:
            x = F.gelu(self.conv(x, f"{p}.conv2", padding=1, groups=int(self.cfg["group"])))
        return self.conv(x, f"{p}.conv3")

    def __call__(self, x_nhwc: torch.Tensor):
        x = x_nhwc.permute(0, 3, 1, 2)
        lrelu = lambda t: F.leaky_relu(t, 0.1)
        y = lrelu(self.norm(self.conv(x, "stem.conv1", 2, 1), "stem.bn1"))
        y = lrelu(self.norm(self.conv(y, "stem.conv2", 1, 1), "stem.bn2"))
        y = self.norm(self.conv(y, "stem.conv3", 1, 1), "stem.bn3")
        ds = self.norm(self.conv(x, "stem.downsample.0", 2, 1), "stem.downsample.1")
        x = F.max_pool2d(lrelu(y + ds), 2, 2)
        block = 0
        for s, n_blocks in enumerate(self.cfg["depth"], start=1):
            if s > 1:
                x = self.norm(self.conv(x, f"patch_embed{s}.proj", 2, 0), f"patch_embed{s}.norm.bn")
            x = x + self.p[f"pos_embed{s}"]
            for i in range(int(n_blocks)):
                p = f"stage{s}.{i}"
                if self.cfg["attn_stage"][s - 1] == "1":
                    x = x + self.branch(self.attention(self.norm(x, f"{p}.norm1.bn"), f"{p}.attn"),
                                        block)
                x = x + self.branch(self.mlp(self.norm(x, f"{p}.norm2.bn"), f"{p}.mlp",
                                             self.cfg["spatial_conv"][s - 1] == "1"),
                                    block)
                block += 1
        x = self.norm(x, "norm.bn")
        return x.permute(0, 2, 3, 1), x.mean(dim=(2, 3))
