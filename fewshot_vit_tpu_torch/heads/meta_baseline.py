"""Meta-Baseline cosine-centroid episodic head (counterpart:
``fewshot_vit_tpu/heads/meta_baseline.py``).

Shots and queries are encoded in ONE batched pass; prototypes are shot
means; logits are cosine (or negative-sqr) similarities in fp32 at a
learnable temperature (fp32, init 10).

Shapes: x_shot (E, way, shot, H, W, 3), x_query (E, Q, H, W, 3) -> (E, Q, way).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.registry import models
from .. import models as _models  # noqa: F401  (registers the encoders)
from ..ops.metric import compute_logits


class MetaBaseline(nn.Module):
    def __init__(self, encoder: nn.Module, method: str = "cos", temp: float = 10.0,
                 temp_learnable: bool = True):
        super().__init__()
        self.encoder = encoder
        self.method = method
        self.temp_init = temp
        self.temp_learnable = temp_learnable
        if temp_learnable:
            self.temp = nn.Parameter(torch.tensor(temp, dtype=torch.float32))
        else:
            self.temp = temp

    def clone(self, encoder: nn.Module) -> "MetaBaseline":
        """A head of the same settings around ``encoder``, on its device."""
        device = next(encoder.parameters()).device
        return MetaBaseline(encoder, self.method, self.temp_init,
                            self.temp_learnable).to(device).eval()

    def forward(self, x_shot: torch.Tensor, x_query: torch.Tensor) -> torch.Tensor:
        e, way, shot = x_shot.shape[:3]
        q = x_query.shape[1]
        img = x_shot.shape[3:]
        x_all = torch.cat([x_shot.reshape(-1, *img), x_query.reshape(-1, *img)])
        _, pooled = self.encoder(x_all)
        n_shot = e * way * shot
        feat_shot = pooled[:n_shot].reshape(e, way, shot, -1)
        feat_query = pooled[n_shot:].reshape(e, q, -1)
        proto = feat_shot.mean(dim=2)  # (E, way, C)
        metric = "cos" if self.method == "cos" else "sqr"
        return compute_logits(feat_query.float(), proto.float(), metric, self.temp)


@models.register("meta-baseline")
def make_meta_baseline(
    encoder: str,
    encoder_args: Optional[dict] = None,
    method: str = "cos",
    temp: float = 10.0,
    temp_learnable: bool = True,
    dtype: torch.dtype = torch.float32,
    device: Any = "cuda",
    seed: int = 0,
) -> MetaBaseline:
    device = resolve_device(device)
    enc = models.make(encoder, dtype=dtype, device=device, seed=seed,
                      **(encoder_args or {}))
    return MetaBaseline(enc, method, temp, temp_learnable).to(device).eval()
