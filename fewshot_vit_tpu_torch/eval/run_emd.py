"""SUN-D (DeepEMD) episodic evaluation CLI (counterpart:
``fewshot_vit_tpu/eval/run_emd.py``).

N-way K-shot DeepEMD accuracy with the SUN-D 95% CI (default 2000 1-shot /
600 5-shot episodes), SFC for shot > 1, grid or fcn patches, on the card by
default.

Run:
  python -m fewshot_vit_tpu_torch.eval.run_emd --config CONFIG.yaml --shot 1 --device cuda

The config is read as the JAX CLI reads it: ``test_dataset`` (else
``val_dataset``) with ``*_args``, ``model_args.encoder(_args)``, ``deepemd``,
``patch_list``, ``patch_ratio``, ``image_size``, ``solver``, ``solver_reg``,
``solver_iters``, ``temperature``, ``feature_pyramid`` and ``sfc_*``.
``solver: sinkhorn_pallas`` runs the CUDA Sinkhorn kernel; ``solver: exact``
the C++ transportation simplex on the host (with a warning on the card:
every EMD batch goes to the host and back). The weights
come from ``load:`` (a whole DeepEMD head: a port checkpoint directory or a
reference ``.pth``, e.g. SUN-D's ``{"params": ...}`` files) or
``load_encoder:`` (the encoder of any head's checkpoint); without either
they are seeded, and the CLI says so.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.config import load_config
from ..core.device import resolve_device
from ..core.registry import datasets, models
from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
from ..heads import deepemd as _heads  # noqa: F401  (registers the heads)
from ..train.runner import resolve_checkpoint
from .emd_eval import evaluate_emd
from .run import RANDOM_WEIGHTS

EXACT_ON_CARD = ("WARNING: solver 'exact' runs the C++ simplex on the HOST: every EMD batch "
                 "goes from the card to the host in float64 and its flows come back, so the "
                 "card waits on the host solver; the on-card solvers are 'sinkhorn_pallas' "
                 "and 'sinkhorn_detached'.")


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the per-episode accuracies."""
    p = argparse.ArgumentParser(description="SUN-D DeepEMD eval (PyTorch/CUDA)")
    p.add_argument("--config", required=True)
    p.add_argument("--shot", type=int, default=None)
    p.add_argument("--episodes", type=int, default=None)
    p.add_argument("--ep-per-batch", type=int, default=4)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 encoder compute (EMD math stays fp32)")
    p.add_argument("--cached", action="store_true",
                   help="encode each image's nodes once (identical logits)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    if cfg.get("solver") == "exact" and dev.type == "cuda":
        print(EXACT_ON_CARD)

    key = "test_dataset" if cfg.get("test_dataset") else "val_dataset"
    ds = datasets.make(cfg.get(key, "mini-imagenet"), **dict(cfg.get(f"{key}_args", {}) or {}))
    way = int(cfg.get("way", 5))
    shot = args.shot if args.shot is not None else int(cfg.get("shot", 1))
    query = int(cfg.get("query", 15))
    n_episodes = args.episodes or (2000 if shot == 1 else 600)
    mode = cfg.get("deepemd", "grid")

    enc_name = cfg.get("model_args.encoder", "visformer_micro_80")
    head = models.make(
        "deepemd",
        encoder=enc_name,
        encoder_args=dict(cfg.get("model_args.encoder_args", {}) or {}),
        temperature=float(cfg.get("temperature", 12.5)),
        solver_reg=float(cfg.get("solver_reg", 0.05)),
        solver_iters=int(cfg.get("solver_iters", 100)),
        solver=cfg.get("solver", "sinkhorn_detached"),
        feature_pyramid=cfg.get("feature_pyramid"),
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=dev, seed=rng_mod.DEFAULT_SEED,
    )
    if resolve_checkpoint(cfg, head, enc_name) is None:
        print(RANDOM_WEIGHTS)
    # the standalone eval's SFC learning rate is 100, not the trainer's 0.1
    sfc_kw = {"steps": int(cfg.get("sfc_update_step", 100)),
              "lr": float(cfg.get("sfc_lr", 100.0)),
              "batch_size": int(cfg.get("sfc_bs", 4))}
    m, h, accs = evaluate_emd(
        head, ds, way=way, shot=shot, query=query, n_episodes=n_episodes,
        ep_per_batch=args.ep_per_batch, mode=mode, cached=args.cached,
        patch_list=cfg.get("patch_list", [2, 3]),
        patch_ratio=float(cfg.get("patch_ratio", 2.0)),
        image_size=int(cfg.get("image_size", 80)), sfc_kw=sfc_kw, device=dev)
    print(f"{way}-way {shot}-shot ({mode}): acc={m * 100:.2f} +- {h * 100:.2f} (%)  "
          f"[{n_episodes} episodes]")
    return accs


if __name__ == "__main__":
    main()
