"""Attention-map visualization (counterpart: ``fewshot_vit_tpu/eval/visualize.py``).

The template's maps: a cls-token attention synthesized from the encoder's
dense features (a mean-pooled pseudo-cls token split into 16 pseudo-heads,
scaled dot-product softmax over the patch tokens, averaged over heads), then
min-max normalized, squared for contrast, upsampled to the image size,
JET-coloured and blended (0.7 image, 0.3 map) onto the denormalized image,
written as JPGs.

``--real-attn`` instead captures the true post-softmax attention of the
forward (``models.common.capture_attention``, the port's form of the JAX
zoo's ``sow``) and overlays the deepest captured block's map, averaged over
heads and queries. Capture changes no dispatch: with ``use_pallas_attn`` a
Visformer's stage 2 still runs the fused-MHSA kernel and is not captured,
so the map is stage 3's, as in JAX.

Run:
  python -m fewshot_vit_tpu_torch.eval.visualize --config configs/test_mini_1shot.yaml --out vis/ --n 16 [--real-attn] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core.config import load_config
from ..core.device import resolve_device
from ..core.registry import datasets
from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
from ..data.transforms import MEAN, STD, normalize
from ..models.common import capture_attention
from ..models.nest import deblockify


def _min_max(amap: torch.Tensor) -> torch.Tensor:
    lo = amap.amin(dim=(1, 2), keepdim=True)
    hi = amap.amax(dim=(1, 2), keepdim=True)
    return (amap - lo) / (hi - lo).clamp_min(1e-8)


def attention_maps(dense: torch.Tensor, num_heads: int = 16) -> torch.Tensor:
    """Dense features (B, H, W, C) -> synthesized attention maps (B, H, W) in [0, 1]."""
    b, h, w, c = dense.shape
    hd = c // num_heads
    tokens = dense.reshape(b, h * w, num_heads, hd)
    cls = tokens.mean(dim=1, keepdim=True)                          # (B, 1, heads, hd)
    attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", cls, tokens) / hd ** 0.5, dim=-1)
    return _min_max(attn.mean(dim=(1, 2)).reshape(b, h, w))


def real_attention_maps(encoder: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """True attention maps (B, H', W') in [0, 1] from one forward of
    ``encoder`` over ``x``: the deepest capturing block's map, Swin's
    image-plane ``attn_map`` (windows stitched, shift undone) when it has
    one, else its weights averaged over heads and queries (global (B, h, T,
    T) on the token grid; NesT's blocked (B, T, h, N, N) deblockified)."""
    with capture_attention() as found:
        encoder(x)
    if not found:
        raise ValueError(f"{type(encoder).__name__} captured no attention: capture is wired "
                         "for the visformer / nest / swin families")
    deepest = found[-1][0]
    at_deepest = {k: v for m, k, v in found if m is deepest}
    if "attn_map" in at_deepest:
        amap = at_deepest["attn_map"]
    else:
        attn = at_deepest["attn"]
        if attn.dim() == 4:
            if attn.shape[0] != x.shape[0]:
                raise ValueError(
                    f"attention batch {attn.shape[0]} != image batch {x.shape[0]} and no "
                    "'attn_map' captured: windowed attention without image-plane geometry")
            amap = attn.mean(dim=(1, 2))
            g = int(np.sqrt(amap.shape[-1]))
            amap = amap.reshape(amap.shape[0], g, g)
        elif attn.dim() == 5:
            amap = attn.mean(dim=(2, 3))                             # (B, T, N)
            amap = deblockify(amap[..., None], int(np.sqrt(amap.shape[-1])))[..., 0]
        else:
            raise ValueError(f"unexpected attention rank {attn.dim()}")
    return _min_max(amap.float())


def _jet(x: np.ndarray) -> np.ndarray:
    """OpenCV-style JET colormap for x in [0, 1] -> uint8 RGB."""
    v = np.clip(x, 0, 1) * 4.0
    r = np.clip(np.minimum(v - 1.5, -v + 4.5), 0, 1)
    g = np.clip(np.minimum(v - 0.5, -v + 3.5), 0, 1)
    b = np.clip(np.minimum(v + 0.5, -v + 2.5), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def overlay(image_norm: np.ndarray, amap: np.ndarray, mean=None, std=None,
            img_weight: float = 0.7) -> np.ndarray:
    """Blend a JET-coloured attention map over a normalized (H, W, 3) image
    -> uint8 RGB; the map is resized bilinearly (PIL) and squared."""
    from PIL import Image

    mean = np.asarray(MEAN if mean is None else mean, np.float32)
    std = np.asarray(STD if std is None else std, np.float32)
    img = np.clip((np.asarray(image_norm, np.float32) * std + mean) * 255.0, 0, 255)
    h, w = img.shape[:2]
    am = np.asarray(Image.fromarray((amap * 255).astype(np.uint8)).resize((w, h), Image.BILINEAR),
                    np.float32) / 255.0
    heat = _jet(am ** 2)
    return (img * img_weight + heat * (1 - img_weight)).astype(np.uint8)


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the maps (N, H', W')."""
    p = argparse.ArgumentParser(description="attention visualization (PyTorch/CUDA)")
    p.add_argument("--config", required=True)
    p.add_argument("--out", default="./vis")
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--real-attn", action="store_true",
                   help="overlay the true post-softmax attention captured from the forward "
                        "instead of the template's feature-synthesized maps")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from PIL import Image

    from .run import load_model_for_eval

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    ds = datasets.make(cfg.get("dataset", "mini-imagenet"),
                       **dict(cfg.get("dataset_args", {}) or {}))
    head = load_model_for_eval(cfg, device=dev)
    os.makedirs(args.out, exist_ok=True)
    x = normalize(torch.from_numpy(np.asarray(ds.images[: args.n])).to(dev), ds.mean, ds.std)
    with torch.inference_mode():
        if args.real_attn:
            maps = real_attention_maps(head.encoder, x)
        else:
            dense, _ = head.encoder(x)
            maps = attention_maps(dense.float())
    maps = maps.cpu().numpy()
    x_np = x.cpu().numpy()
    for i in range(len(x_np)):
        Image.fromarray(overlay(x_np[i], maps[i], ds.mean, ds.std)).save(
            os.path.join(args.out, f"{i}.jpg"))
    print(f"wrote {len(x_np)} overlays to {args.out}")
    return maps


if __name__ == "__main__":
    main()
