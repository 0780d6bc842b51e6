"""Episodic evaluation CLI (counterpart: ``fewshot_vit_tpu/eval/run.py``).

N-way K-shot accuracy with a 95% CI over ``--test-epochs`` x ``--episodes``
episodes of a MetaBaseline head, on the card by default; ``--sauc`` scores
2-way episodes as the ROC-AUC of each query's cosine to the class-0
prototype instead.

Run:
  python -m fewshot_vit_tpu_torch.eval.run --config configs/test_mini_1shot.yaml --shot 1 --fold-bn --bf16
  python -m fewshot_vit_tpu_torch.eval.run --config ... --sauc
  python -m fewshot_vit_tpu_torch.eval.run --config ... --int8 [--bf16]

The config names ``dataset``, ``dataset_args``, ``encoder`` and
``model_args.encoder_args`` as the JAX CLI's does, and the weights as
``load:`` (a whole head: a port checkpoint directory or a reference ``.pth``)
or ``load_encoder:`` (the encoder of any head's checkpoint, directory or
``.pth``). Without either the weights are seeded, and the CLI says so.
"""

from __future__ import annotations

import argparse
from typing import Any, Optional

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.config import Config, load_config
from ..core.device import resolve_device
from ..core.registry import datasets, models
from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
from ..data.datasets import ArrayDataset
from ..data.staging import upload_images
from ..data.transforms import normalize
from ..heads import meta_baseline as _heads  # noqa: F401  (registers the heads)
from ..ops.metric import l2_normalize, mean_confidence_interval, roc_auc
from ..train.runner import AUXILIARIES, resolve_checkpoint
from .episodic import (
    _on_device,
    _upload,
    encode_dataset,
    evaluate,
    evaluate_cached,
    sample_episode_indices,
)

EP_PER_BATCH = 8  # as the JAX CLI, so both draw the same episodes from a seed
RANDOM_WEIGHTS = "WARNING: no 'load' or 'load_encoder' in the config: the weights are random"


def load_model_for_eval(cfg: Config, dtype: torch.dtype = torch.float32, device: Any = "cuda"):
    """A MetaBaseline head over the config's encoder, on ``device``, with the
    config's ``load:`` / ``load_encoder:`` applied (``train.runner.
    resolve_checkpoint``). The head is built unfolded: ``--fold-bn`` folds
    the loaded weights afterwards."""
    enc_name = cfg.get("encoder", cfg.get("model_args.encoder", "visformer_micro_80"))
    head = models.make("meta-baseline", encoder=enc_name,
                       encoder_args=dict(cfg.get("model_args.encoder_args", {}) or {}),
                       dtype=dtype, device=device, seed=rng_mod.DEFAULT_SEED)
    resolve_checkpoint(cfg, head, enc_name)
    return head


def calibration_images(ds: ArrayDataset, device: Any = "cuda") -> torch.Tensor:
    """The JAX CLI's ``--int8`` calibration batch: min(256, N) images drawn
    without replacement from ``np_rng(DEFAULT_SEED)`` (a random sample: the
    images are class-contiguous, so a prefix would calibrate on about one
    class), in index order, normalized, on ``device``."""
    idx = rng_mod.np_rng(rng_mod.DEFAULT_SEED).choice(
        len(ds.images), size=min(256, len(ds.images)), replace=False)
    images = torch.from_numpy(np.asarray(ds.images[np.sort(idx)])).to(resolve_device(device))
    return normalize(images, ds.mean, ds.std)


@torch.inference_mode()
def sauc_eval(head: torch.nn.Module, dataset: ArrayDataset, n_episodes: int, shot: int,
              query: int = 15, ep_per_batch: int = EP_PER_BATCH,
              seed: int = rng_mod.DEFAULT_SEED, images_dev: Optional[torch.Tensor] = None,
              device: Any = "cuda"):
    """2-way ROC-AUC mode (reference ``test_few_shot.py:95-112``): per
    episode, each query's cosine to the l2-normalized mean of class 0's
    shots, scored against "is class 0" by ``roc_auc``. The episodes are the
    JAX CLI's (2-way batches of ``ep_per_batch`` from ``np_rng(seed)``).
    Returns (mean AUC, Student-t 95% half-width, per-episode AUCs)."""
    dev = resolve_device(device)
    _on_device(head, dev)
    indices = sample_episode_indices(dataset, n_episodes, 2, shot + query, ep_per_batch, seed)
    idx_all = torch.from_numpy(indices.astype(np.int64)).to(dev)
    images_dev = _upload(dataset, images_dev, dev)
    scores = []
    for idx in idx_all:
        x = normalize(images_dev[idx], dataset.mean, dataset.std)
        _, pooled = head.encoder(x)
        f = pooled.float().reshape(ep_per_batch, 2, shot + query, -1)
        proto = l2_normalize(f[:, 0, :shot].mean(dim=1))  # (E, C)
        q = l2_normalize(f[:, :, shot:].reshape(ep_per_batch, 2 * query, -1))
        scores.append(torch.einsum("eqc,ec->eq", q, proto))
    scores = torch.cat(scores).cpu().numpy()[:n_episodes]
    y = np.array([1] * query + [0] * query)
    aucs = np.asarray([roc_auc(s, y) for s in scores])
    m, h = mean_confidence_interval(aucs)
    return m, h, aucs


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns every test epoch's per-episode accuracies (AUCs
    with ``--sauc``)."""
    p = argparse.ArgumentParser(description="few-shot eval (PyTorch/CUDA)")
    p.add_argument("--config", required=True)
    p.add_argument("--shot", type=int, default=1)
    p.add_argument("--test-epochs", type=int, default=1)
    p.add_argument("--sauc", action="store_true",
                   help="2-way episodes scored by ROC-AUC of the cosine to class 0's prototype")
    p.add_argument("--episodes", type=int, default=2000)
    p.add_argument("--cached", action="store_true",
                   help="cached-features fast path (identical accuracy)")
    p.add_argument("--fold-bn", action="store_true",
                   help="fold frozen-stats BNs into the adjacent convs (exact)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 encoder compute")
    p.add_argument("--int8", action="store_true",
                   help="EXPERIMENTAL: int8 encoder weights and static activation scales "
                        "calibrated on a random sample of the eval set (implies --fold-bn; "
                        "models/quant.py)")
    p.add_argument("--mesh-data", type=int, default=0, help="not ported (episode mesh)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.mesh_data:
        raise NotImplementedError(f"'--mesh-data' (multi-device eval) {AUXILIARIES}")
    dev = resolve_device(args.device)
    cfg = load_config(args.config)

    ds = datasets.make(cfg.get("dataset", "mini-imagenet"),
                       **dict(cfg.get("dataset_args", {}) or {}))
    head = load_model_for_eval(cfg, torch.bfloat16 if args.bf16 else torch.float32, dev)
    if not (cfg.get("load") or cfg.get("load_encoder")):
        print(RANDOM_WEIGHTS)
    if args.int8:  # after loading; folds first, as JAX's quantize_encoder_in_head
        from ..models.quant import quantize_encoder_in_head

        head = quantize_encoder_in_head(head, calib_images=calibration_images(ds, dev))
    elif args.fold_bn:  # after loading: the folded encoder has no BN entries
        from ..models.fold import fold_encoder_in_head

        head = fold_encoder_in_head(head)
    # one upload, shared across test epochs; cached mode encodes once
    images_dev = upload_images(ds.images, dev)
    feats = None
    if args.cached and not args.sauc:
        feats = encode_dataset(head.encoder, ds, images_dev=images_dev, device=dev)
        images_dev = None

    all_accs = []
    for epoch in range(1, args.test_epochs + 1):
        seed = rng_mod.DEFAULT_SEED + epoch - 1
        if args.sauc:
            _, _, accs = sauc_eval(head, ds, args.episodes, args.shot, seed=seed,
                                   images_dev=images_dev, device=dev)
        elif args.cached:
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
    return np.asarray(all_accs)


if __name__ == "__main__":
    main()
