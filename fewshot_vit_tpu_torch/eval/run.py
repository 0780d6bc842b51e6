"""Episodic evaluation CLI (counterpart: ``fewshot_vit_tpu/eval/run.py``).

N-way K-shot accuracy with a 95% CI over ``--test-epochs`` x ``--episodes``
episodes of a MetaBaseline head, on the card by default.

Run:
  python -m fewshot_vit_tpu_torch.eval.run --config CONFIG.yaml --shot 1 --fold-bn --bf16

The config names ``dataset``, ``dataset_args``, ``encoder`` and
``model_args.encoder_args`` as the JAX CLI's does. Weights are seeded;
loading a checkpoint (``load:`` / ``load_encoder:``) is not ported yet.
"""

from __future__ import annotations

import argparse

import torch

from ..core import rng as rng_mod
from ..core.config import load_config
from ..core.device import resolve_device
from ..core.registry import datasets, models
from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
from ..heads import meta_baseline as _heads  # noqa: F401  (registers the heads)
from ..ops.metric import mean_confidence_interval
from .episodic import encode_dataset, evaluate, evaluate_cached

EP_PER_BATCH = 8  # as the JAX CLI, so both draw the same episodes from a seed


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="few-shot eval (PyTorch/CUDA)")
    p.add_argument("--config", required=True)
    p.add_argument("--shot", type=int, default=1)
    p.add_argument("--test-epochs", type=int, default=1)
    p.add_argument("--episodes", type=int, default=2000)
    p.add_argument("--cached", action="store_true",
                   help="cached-features fast path (identical accuracy)")
    p.add_argument("--fold-bn", action="store_true",
                   help="fold frozen-stats BNs into the adjacent convs (exact)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 encoder compute")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    if cfg.get("load") or cfg.get("load_encoder"):
        raise NotImplementedError(
            "checkpoint loading ('load' / 'load_encoder') is not ported yet: "
            "ROADMAP.md section 1, item 7 (checkpoint/io.py .pth ingestion)")

    ds = datasets.make(cfg.get("dataset", "mini-imagenet"),
                       **dict(cfg.get("dataset_args", {}) or {}))
    head = models.make(
        "meta-baseline",
        encoder=cfg.get("encoder", cfg.get("model_args.encoder", "visformer_micro_80")),
        encoder_args=dict(cfg.get("model_args.encoder_args", {}) or {}),
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=dev, seed=rng_mod.DEFAULT_SEED,
    )
    if args.fold_bn:
        from ..models.fold import fold_encoder_in_head

        head = fold_encoder_in_head(head)
    # one upload, shared across test epochs; cached mode encodes once
    images_dev = torch.from_numpy(ds.images).to(dev)
    feats = None
    if args.cached:
        feats = encode_dataset(head.encoder, ds, images_dev=images_dev, device=dev)
        images_dev = None

    all_accs = []
    for epoch in range(1, args.test_epochs + 1):
        seed = rng_mod.DEFAULT_SEED + epoch - 1
        if args.cached:
            _, _, accs = evaluate_cached(
                head.encoder, ds, n_episodes=args.episodes, shot=args.shot,
                ep_per_batch=EP_PER_BATCH, temp=float(head.temp), seed=seed,
                feats=feats, device=dev)
        else:
            _, _, accs = evaluate(
                head, ds, n_episodes=args.episodes, shot=args.shot,
                ep_per_batch=EP_PER_BATCH, seed=seed, images_dev=images_dev, device=dev)
        all_accs.extend(accs.tolist())
        m, h = mean_confidence_interval(all_accs)
        print(f"test epoch {epoch}: acc={m * 100:.2f} +- {h * 100:.2f} (%)")


if __name__ == "__main__":
    main()
