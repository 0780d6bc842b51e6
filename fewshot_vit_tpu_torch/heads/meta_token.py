"""Meta-token episodic heads: support-token <-> query-patch cross-attention
(counterpart: ``fewshot_vit_tpu/heads/meta_token.py``; the reference's
experimental ``meta-token`` / ``-v2`` / ``-v3`` with ``TokenQKV``,
``TokenQKV_Local``, ``Sampling`` and ``SamplingKeepToken``).

Episode layout: x_shot (E, way, shot, H, W, 3), x_query (E, way, query, H, W,
3), grouped by class (the reference reshapes the query features to (b, n,
q, hw, c)). The encoder runs twice, once over the shots and once over the
queries, as in the reference. Returns ``(logits, cls_logits)``:

* ``logits``: per-(query, support item) token-attention similarities,
  (E, way*query, way*shot), read with ``compute_acc_kshots``;
* ``cls_logits``: pooled cosine-prototype logits, (E, way*query, way).

The reference's classifier ``nn.Linear``, which its forward never touches,
is left out. ``standard_episodic = False``: no trainer drives these heads.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.registry import models
from ..models.common import Linear, init_weights
from ..ops.metric import (
    compute_logits,
    compute_logits_kshot,
    compute_logits_local_kshot,
    l2_normalize,
)


def token_qkv(feat_query: torch.Tensor, x_support: torch.Tensor,
              num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parameter-free support-token -> query-patch attention (reference
    ``TokenQKV``, whose q/k/v projections are all commented out).

    feat_query (b, n, q, hw, c), x_support (b, n, k, c) ->
    o_query (b, n*q, n*k, c), o_support (b, 1, n*k, c)."""
    b, n, k, c = x_support.shape
    q, hw = feat_query.shape[2], feat_query.shape[3]
    h = num_heads
    cs = c // h
    support_flat = x_support.reshape(b, n * k, c)
    qs = support_flat.reshape(b, n * k, h, cs).permute(0, 2, 1, 3)           # (b, h, nk, cs)
    kq = feat_query.reshape(b, n * q, hw, h, cs).permute(0, 1, 3, 2, 4)     # (b, nq, h, hw, cs)
    attn = torch.softmax(torch.einsum("bhmc,bqhtc->bqhmt", qs, kq) * cs ** -0.5, dim=-1)
    o_query = torch.einsum("bqhmt,bqhtc->bqhmc", attn, kq)
    o_query = o_query.permute(0, 1, 3, 2, 4).reshape(b, n * q, n * k, c)
    return o_query, support_flat[:, None]


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the lower
    index (a stable descending sort; ``torch.topk`` orders ties freely)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _attend_select(token: torch.Tensor, feature: torch.Tensor, rate: float):
    """The patch selection of ``Sampling`` / ``SamplingKeepToken``: the
    pooled token's attention over its patches, the top ``rate`` share kept
    and their weights renormalized.

    token (b, n, k, c), feature (b, n, k, hw, c) ->
    sel_attn (b, n*k, kk), sel_feat (b, n*k, kk, c)."""
    b, n, k, c = token.shape
    hw = feature.shape[3]
    kk = int(hw * rate)
    if kk < 1:
        raise ValueError(
            f"sampling rate {rate} keeps int({hw}*{rate})=0 patches; the "
            "renormalization would divide by zero")
    t = token.reshape(b, n * k, 1, c)
    f = feature.reshape(b, n * k, hw, c)
    attn = torch.softmax(torch.einsum("bmxc,bmtc->bmxt", t, f) * c ** -0.5, dim=-1)[:, :, 0]
    sel_attn, sel_idx = _top_k(attn, kk)
    sel_attn = sel_attn / sel_attn.sum(dim=-1, keepdim=True)
    sel_feat = torch.take_along_dim(f, sel_idx[..., None], dim=2)
    return sel_attn, sel_feat


def sampling_pool(token: torch.Tensor, feature: torch.Tensor, rate: float = 0.5) -> torch.Tensor:
    """Attention-select the top ``rate`` patches and average them into a new
    token (reference ``Sampling``): (b, n, k, c), (b, n, k, hw, c) -> (b, n, k, c)."""
    b, n, k, c = token.shape
    sel_attn, sel_feat = _attend_select(token, feature, rate)
    return torch.einsum("bmt,bmtc->bmc", sel_attn, sel_feat).reshape(b, n, k, c)


def sampling_keep(token: torch.Tensor, feature: torch.Tensor, rate: float = 0.5) -> torch.Tensor:
    """The same selection, keeping the weighted patches (reference
    ``SamplingKeepToken``): -> (b, n, k, int(hw*rate), c)."""
    b, n, k, c = token.shape
    sel_attn, sel_feat = _attend_select(token, feature, rate)
    return (sel_attn[..., None] * sel_feat).reshape(b, n, k, sel_attn.shape[-1], c)


class TokenQKVLocal(nn.Module):
    """Projected local-token cross-attention (reference ``TokenQKV_Local``):
    q from the support patches, k and v from the query patches.

    x_query (b, n, q, hw, c), x_support (b, n, k, hw, c) ->
    o_query, o_support, each (b, n*q, n*k, hw, c)."""

    def __init__(self, dim: int, num_heads: int = 1, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(dim, dim, qkv_bias, dtype, init="lecun")
        self.k = Linear(dim, dim, qkv_bias, dtype, init="lecun")
        self.v = Linear(dim, dim, qkv_bias, dtype, init="lecun")

    def forward(self, x_query: torch.Tensor, x_support: torch.Tensor):
        b, n, k, hw_s, c = x_support.shape
        q, hw = x_query.shape[2], x_query.shape[3]
        h = self.num_heads
        cs = c // h
        sup = x_support.reshape(b, n, k * hw_s, c)
        qs = self.q(sup).reshape(b, n * k * hw_s, h, cs).permute(0, 2, 1, 3)
        kq = self.k(x_query).reshape(b, n * q, hw, h, cs).permute(0, 1, 3, 2, 4)
        vq = self.v(x_query).reshape(b, n * q, hw, h, cs).permute(0, 1, 3, 2, 4)
        attn = torch.softmax(torch.einsum("bhmc,bqhtc->bqhmt", qs, kq) * cs ** -0.5, dim=-1)
        o_query = torch.einsum("bqhmt,bqhtc->bqhmc", attn, vq)
        o_query = o_query.permute(0, 1, 3, 2, 4).reshape(b, n * q, n * k, hw_s, c)
        o_support = self.v(sup).reshape(b, 1, n * k, hw_s, c).expand(b, n * q, n * k, hw_s, c)
        return o_query, o_support


class _MetaTokenBase(nn.Module):
    # grouped (E, way, query, ...) queries and a tuple return: not the
    # (x_shot, x_query) -> (E, Q, way) contract of the meta-tune loop
    standard_episodic = False

    def __init__(self, encoder: nn.Module, num_heads: int = 1, method: str = "cos",
                 temp: float = 10.0, temp_learnable: bool = True):
        super().__init__()
        if method != "cos":
            # the reference implements cosine only: its compute_logits_kshot
            # has no metric branch, and 'sqr' dies in compute_logits_local
            raise ValueError(f"meta-token heads implement method='cos' only, got {method!r}")
        self.encoder = encoder
        self.num_heads = num_heads
        if temp_learnable:
            self.temp = nn.Parameter(torch.tensor(temp, dtype=torch.float32))
        else:
            self.temp = temp

    def _encode(self, x_shot: torch.Tensor, x_query: torch.Tensor):
        """-> feat_shot (E, way, shot, hw, C), feat_query (E, way, q, hw, C),
        x_s (E, way, shot, C), x_q (E, way, q, C), in the encoder's dtype;
        NHWC maps flatten row-major over (h, w), the reference's token order."""
        e, way, shot = x_shot.shape[:3]
        q = x_query.shape[2]
        img = x_shot.shape[3:]
        dense_s, pooled_s = self.encoder(x_shot.reshape(-1, *img))
        dense_q, pooled_q = self.encoder(x_query.reshape(-1, *img))
        c = pooled_s.shape[-1]
        return (dense_s.reshape(e, way, shot, -1, c), dense_q.reshape(e, way, q, -1, c),
                pooled_s.reshape(e, way, shot, c), pooled_q.reshape(e, way, q, c))

    @staticmethod
    def _cls_logits(x_shot: torch.Tensor, x_query: torch.Tensor, temp) -> torch.Tensor:
        """Pooled cosine-prototype logits: shot mean, both normalized, dot at temp."""
        e, way, q = x_query.shape[:3]
        proto = l2_normalize(x_shot.mean(dim=-2))
        feat = l2_normalize(x_query.reshape(e, way * q, -1))
        return compute_logits(feat, proto, "dot", temp)


class MetaToken(_MetaTokenBase):
    """``meta-token``: parameter-free TokenQKV between the pooled support
    tokens and the query patch maps."""

    def forward(self, x_shot: torch.Tensor, x_query: torch.Tensor):
        _, feat_query, x_s, x_q = self._encode(x_shot, x_query)
        o_query, o_support = token_qkv(feat_query, x_s, self.num_heads)
        return (compute_logits_kshot(o_query, o_support, self.temp),
                self._cls_logits(x_s, x_q, self.temp))


class MetaTokenV2(_MetaTokenBase):
    """``meta-token-v2``: the support tokens are first re-pooled from their
    top-50% salient patches (``sampling_pool``); the cls path uses the
    re-pooled tokens too, as the reference."""

    def forward(self, x_shot: torch.Tensor, x_query: torch.Tensor):
        feat_shot, feat_query, x_s, x_q = self._encode(x_shot, x_query)
        x_s = sampling_pool(x_s, feat_shot)
        o_query, o_support = token_qkv(feat_query, x_s, self.num_heads)
        return (compute_logits_kshot(o_query, o_support, self.temp),
                self._cls_logits(x_s, x_q, self.temp))


class MetaTokenV3(_MetaTokenBase):
    """``meta-token-v3``: both sides keep their top-50% patches
    (``sampling_keep``), matched by the projected local cross-attention
    (``transformer``, a ``TokenQKVLocal``) and the mean local cosine; the
    cls path uses the original pooled tokens."""

    def __init__(self, encoder: nn.Module, num_heads: int = 1, qkv_bias: bool = True,
                 method: str = "cos", temp: float = 10.0, temp_learnable: bool = True,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__(encoder, num_heads, method, temp, temp_learnable)
        self.transformer = TokenQKVLocal(encoder.out_dim, num_heads, qkv_bias, dtype)
        init_weights(self.transformer, torch.Generator().manual_seed(seed + 1))

    def forward(self, x_shot: torch.Tensor, x_query: torch.Tensor):
        feat_shot, feat_query, x_s, x_q = self._encode(x_shot, x_query)
        o_query, o_support = self.transformer(sampling_keep(x_q, feat_query),
                                              sampling_keep(x_s, feat_shot))
        return (compute_logits_local_kshot(o_query, o_support, self.temp),
                self._cls_logits(x_s, x_q, self.temp))


def _make(cls, encoder, encoder_args, enc_dtype, device, enc_seed, **kw):
    device = resolve_device(device)
    enc = models.make(encoder, dtype=enc_dtype, device=device, seed=enc_seed,
                      **(encoder_args or {}))
    return cls(enc, **kw).to(device).eval()


@models.register("meta-token")
def make_meta_token(encoder: str, encoder_args: Optional[dict] = None, num_heads: int = 1,
                    method: str = "cos", temp: float = 10.0, temp_learnable: bool = True,
                    dtype: torch.dtype = torch.float32, device: Any = "cuda", seed: int = 0,
                    **_: Any) -> MetaToken:
    return _make(MetaToken, encoder, encoder_args, dtype, device, seed, num_heads=num_heads,
                 method=method, temp=temp, temp_learnable=temp_learnable)


@models.register("meta-token-v2")
def make_meta_token_v2(encoder: str, encoder_args: Optional[dict] = None, num_heads: int = 1,
                       method: str = "cos", temp: float = 10.0, temp_learnable: bool = True,
                       dtype: torch.dtype = torch.float32, device: Any = "cuda", seed: int = 0,
                       **_: Any) -> MetaTokenV2:
    return _make(MetaTokenV2, encoder, encoder_args, dtype, device, seed, num_heads=num_heads,
                 method=method, temp=temp, temp_learnable=temp_learnable)


@models.register("meta-token-v3")
def make_meta_token_v3(encoder: str, encoder_args: Optional[dict] = None, num_heads: int = 1,
                       qkv_bias: bool = True, method: str = "cos", temp: float = 10.0,
                       temp_learnable: bool = True, dtype: torch.dtype = torch.float32,
                       device: Any = "cuda", seed: int = 0, **_: Any) -> MetaTokenV3:
    return _make(MetaTokenV3, encoder, encoder_args, dtype, device, seed, num_heads=num_heads,
                 qkv_bias=qkv_bias, method=method, temp=temp, temp_learnable=temp_learnable,
                 dtype=dtype, seed=seed)
