"""Swin Transformer (counterpart: ``fewshot_vit_tpu/models/swin.py``).

  * a 4x4/s4 patch embed + LayerNorm, or Visformer's residual 3-conv stem
    (``conv_stem``, the reference's swin_3conv), flattened to tokens;
  * stages of window attention with a learned relative position bias;
    odd blocks shift the windows cyclically by ``window // 2`` (``torch.roll``)
    under a static additive mask (-100 across regions); a window at least as
    large as the stage's grid is clamped to it, with no shift;
  * PatchMerging between stages: the [0::2, 0::2], [1::2, 0::2], [0::2, 1::2],
    [1::2, 1::2] quadrants concatenated, LayerNorm, a bias-free reduction to
    2C; the ``adapool`` variant smooths with a 3x3/s1 average pool first
    (padding counted, as flax's ``avg_pool``);
  * LayerNorm eps 1e-5; forward: NHWC (B, H, W, 3) -> (dense NHWC, pooled).

Spans (``core/trace.py``): ``encoder`` > ``encoder.stem`` (patch embed and
its norm), ``encoder.stage1`` .. ``encoder.stage<n>`` (a stage holds the
PatchMerging that feeds it; the last one the final norm and pooling), and in
every block ``encoder.window_attn`` (the qkv projection, the shifted-window
attention, the proj projection; ``norm1`` stays outside). Counter
``encoder.windows``: windows attended, one per window of every image in
every block; ``encoder.windows_fused``: those of them the window kernel
computed.

Two routes for a block's attention, chosen from what the block observes
(``window_route``): the hand-written kernel (``kernels/window.py``,
``csrc/window_attn.cu``) on the un-rolled grid between the qkv and proj
projections, on CUDA tensors in bf16 without autograd or capture, with
attention dropout off, for windows and head widths it is compiled for; else
the einsum path (roll, partition, einsums, bias, mask, softmax, reverse,
roll back), which also records the probabilities a capture asks for.

State-dict keys are the reference's (``layers.0.blocks.1.attn.qkv``,
``layers.0.downsample.reduction``, ``patch_embed.proj``), the keys
``checkpoint/from_flax.py::swin_key`` gives. The relative position index and
the shift masks are non-persistent buffers.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import trace
from ..core.device import resolve_device
from ..core.registry import models
from ..kernels.window import kernel_takes, window_attention
from .common import (
    Conv,
    DropPath,
    Dropout,
    LayerNorm,
    Linear,
    capturing,
    gelu,
    init_weights,
    sow,
    trunc_normal_,
)
from .visformer import ConvStem, drop_path_ladder

LN_EPS = 1e-5


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws * ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B * nW, ws * ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """Static (ws*ws, ws*ws) index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shifted_window_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Static additive mask (nW, ws*ws, ws*ws) for shifted windows."""
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img.reshape(1, h // ws, ws, w // ws, ws).transpose(0, 1, 3, 2, 4).reshape(-1, ws * ws)
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, qkv_bias, dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window).reshape(-1)), persistent=False)
        self.proj = Linear(dim, dim, True, dtype)
        self.attn_drop, self.proj_drop = Dropout(attn_drop), Dropout(proj_drop)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                grid: Optional[int] = None, shift: int = 0) -> torch.Tensor:
        """``grid`` (the block's token-grid edge) and ``shift`` let a capture
        stitch the windows' head- and query-averaged attention back onto the
        image plane (``attn_map``, (B, grid, grid))."""
        b_, n, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k, v = self.qkv(x).reshape(b_, n, 3, h, hd).unbind(2)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1).to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, h, n, n) + mask.to(attn.dtype)[None, :, None]
            attn = attn.reshape(b_, h, n, n)
        attn = torch.softmax(attn, dim=-1)
        sow(self, "attn", attn)
        if grid is not None and capturing():
            ws = int(round(n ** 0.5))
            amap = window_reverse(attn.mean(dim=(1, 2))[..., None], ws, grid, grid)
            if shift > 0:
                amap = torch.roll(amap, (shift, shift), dims=(1, 2))
            sow(self, "attn_map", amap[..., 0])
        attn = self.attn_drop(attn)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b_, n, c)
        return self.proj_drop(self.proj(out))

    def fused(self, y: torch.Tensor, window: int, shift: int) -> torch.Tensor:
        """(B, R, R, C) -> (B, R, R, C): qkv on the un-rolled grid, the window
        kernel, proj; the same function as roll, partition, ``forward``,
        reverse and roll back."""
        hd = y.shape[-1] // self.num_heads
        out = window_attention(self.qkv(y), self.relative_position_bias_table, self.num_heads,
                               window, shift, hd ** -0.5)
        return self.proj_drop(self.proj(out))


class Mlp(nn.Module):
    """fc1 -> GELU -> dropout -> fc2 -> dropout (keys ``mlp.fc1`` / ``mlp.fc2``),
    the MLP of every token transformer of the zoo."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden, True, dtype)
        self.fc2 = Linear(hidden, dim, True, dtype)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(gelu(self.fc1(x)))))


def window_route(device: torch.device, dtype: torch.dtype, tokens: int, head_dim: int,
                 dropout: bool) -> bool:
    """True where a block's attention takes the window kernel: CUDA
    tensors, a dtype and shape the kernel is compiled for, no gradient
    recorded, no capture (it needs the probabilities), attention dropout
    off. Everything else takes the einsum path."""
    return (device.type == "cuda" and kernel_takes(dtype, tokens, head_dim)
            and not torch.is_grad_enabled() and not capturing() and not dropout)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, resolution: int, num_heads: int, window: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if resolution <= window:  # window no smaller than the grid: one window, no shift
            window, shift = resolution, 0
        if resolution % window:
            raise ValueError(
                f"Swin window {window} does not tile the {resolution}x{resolution} token "
                "grid (build the encoder at the image size it was designed for)")
        self.resolution, self.window, self.shift = resolution, window, shift
        self.norm1 = LayerNorm(dim, LN_EPS, dtype)
        self.attn = WindowAttention(dim, window, num_heads, qkv_bias, attn_drop, drop, dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, LN_EPS, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, dtype)
        mask = (torch.from_numpy(shifted_window_mask(resolution, resolution, window, shift))
                if shift > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        r, ws, s = self.resolution, self.window, self.shift
        y = self.norm1(x).reshape(b, r, r, c)
        drop = self.attn.attn_drop
        with trace.span("encoder.window_attn"):
            trace.count("encoder.windows", b * (r // ws) ** 2)
            if window_route(y.device, y.dtype, ws * ws, c // self.attn.num_heads,
                            drop.rate > 0 and drop.training):
                trace.count("encoder.windows_fused", b * (r // ws) ** 2)
                y = self.attn.fused(y, ws, s)
            else:
                y = self.einsum_attention(y)
        x = x + self.drop_path(y.reshape(b, l, c))
        return x + self.drop_path(self.mlp(self.norm2(x)))

    def einsum_attention(self, y: torch.Tensor) -> torch.Tensor:
        """(B, R, R, C) -> (B, R, R, C): roll, partition, ``WindowAttention``,
        reverse, roll back."""
        r, ws, s = self.resolution, self.window, self.shift
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = window_reverse(self.attn(window_partition(y, ws), self.attn_mask, r, s), ws, r, r)
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        return y


class PatchMerging(nn.Module):
    def __init__(self, dim: int, resolution: int, smooth: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resolution, self.smooth = resolution, smooth
        self.norm = LayerNorm(4 * dim, LN_EPS, dtype)
        self.reduction = Linear(4 * dim, 2 * dim, False, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        r = self.resolution
        x = x.reshape(b, r, r, c)
        if self.smooth:
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(b, (r // 2) * (r // 2), 4 * c)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    """The plain 4x4 patch conv + LayerNorm (``patch_embed.proj`` / ``.norm``)."""

    def __init__(self, patch: int, dim: int, norm: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv(3, dim, patch, patch, 0, bias=True, dtype=dtype, init="trunc")
        self.norm = LayerNorm(dim, LN_EPS, dtype) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x)
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        return x if self.norm is None else self.norm(x)


class SwinStage(nn.Module):
    """``layers.i``: its ``blocks`` and the ``downsample`` after them."""

    def __init__(self, blocks, downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """``forward -> (dense NHWC, pooled)``; ``dtype`` is the compute dtype,
    parameters stay fp32, weights drawn on the CPU from ``seed``."""

    def __init__(
        self,
        img_size: int = 96,
        patch_size: int = 4,
        embed_dim: int = 64,
        depths: Sequence[int] = (1, 1, 1, 2),
        num_heads: Sequence[int] = (2, 4, 8, 16),
        window_size: int = 6,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.1,
        ape: bool = False,
        patch_norm: bool = True,
        conv_stem: bool = False,
        stem_hidden: int = 64,
        merge_smooth: bool = False,
        dtype: torch.dtype = torch.float32,
        device: Any = "cuda",
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.img_size = img_size
        self.out_dim = int(embed_dim * 2 ** (len(depths) - 1))
        if conv_stem:
            self.patch_embed = ConvStem(stem_hidden, embed_dim, dtype=dtype)
            grid = img_size // 4  # the stem's stride
        else:
            self.patch_embed = PatchEmbed(patch_size, embed_dim, patch_norm, dtype)
            grid = img_size // patch_size
        if ape:
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, grid * grid, embed_dim))
        self.pos_drop = Dropout(drop_rate)
        dpr = drop_path_ladder(drop_path_rate, sum(depths))
        stages, first, res = [], 0, grid
        for i, depth in enumerate(depths):
            dim = int(embed_dim * 2 ** i)
            blocks = [SwinBlock(dim, res, num_heads[i], window_size,
                                0 if j % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
                                drop_rate, attn_drop_rate, dpr[first + j], dtype)
                      for j in range(depth)]
            first += depth
            down = None
            if i < len(depths) - 1:
                down = PatchMerging(dim, res, merge_smooth, dtype)
                res //= 2
            stages.append(SwinStage(blocks, down))
        self.layers = nn.ModuleList(stages)
        self.res = res
        self.norm = LayerNorm(self.out_dim, LN_EPS, dtype)

        gen = torch.Generator().manual_seed(seed)
        init_weights(self, gen)
        for name, p in self.named_parameters():
            if name.endswith(("relative_position_bias_table", "absolute_pos_embed")):
                trunc_normal_(p, 0.02, gen)
        self.to(device).eval()

    def forward(self, x: torch.Tensor):
        if x.shape[1:3] != (self.img_size, self.img_size):
            raise ValueError(f"this Swin is built for {self.img_size}x{self.img_size} inputs, "
                             f"got {tuple(x.shape[1:3])}")
        b = x.shape[0]
        with trace.span("encoder"):
            with trace.span("encoder.stem"):
                x = self.patch_embed(x)
                if x.dim() == 4:  # the conv stem's map
                    x = x.reshape(b, -1, x.shape[-1])
                if hasattr(self, "absolute_pos_embed"):
                    x = x + self.absolute_pos_embed
                x = self.pos_drop(x)
            for i, stage in enumerate(self.layers, start=1):
                with trace.span(f"encoder.stage{i}"):
                    if i > 1:
                        x = self.layers[i - 2].downsample(x)
                    for blk in stage.blocks:
                        x = blk(x)
                    if stage.downsample is None:  # the last stage: final norm and pooling
                        x = self.norm(x)
                        return x.reshape(b, self.res, self.res, -1), x.mean(dim=1)


_MICRO = dict(img_size=80, patch_size=4, window_size=5, embed_dim=144, depths=(2, 3, 2),
              num_heads=(4, 8, 16), drop_path_rate=0.5, conv_stem=True)
_VARIANTS = {
    # Liu et al., ICCV 2021: configs/swin/swin_tiny_patch4_window7_224.yaml
    "swin_tiny_patch4_window7_224": dict(img_size=224, patch_size=4, window_size=7, embed_dim=96,
                                         depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                                         drop_path_rate=0.2),
    # built for 96 px despite its name: on 80 px the JAX package fails too
    "swin_nano_patch4_window5_80": dict(img_size=96, patch_size=4, window_size=6, embed_dim=64,
                                        depths=(1, 1, 1, 2), num_heads=(2, 4, 8, 16)),
    "swin_micro_resembed_80": _MICRO,
    "swin_micro_v2_resembed_ada_80": dict(_MICRO, merge_smooth=True),
}

for _name, _cfg in _VARIANTS.items():
    models.register(_name)(lambda _cfg=_cfg, **kw: SwinTransformer(**{**_cfg, **kw}))
