"""End-to-end learning probe: the four training phases on synthetic
localized-signal data must give real few-shot transfer (counterpart: the
repository's ``tools/learning_probe.py``).

Runs, in one process on the card (or the CPU with ``--device cpu``):

  p0  untrained encoder            -> episodic 5-way 1-shot acc on NOVEL classes
  p1  phase-1 CE pretraining       -> acc of its encoder
  p2  phase-2 SUN token labeling   -> acc of its encoder
  p3  phase-3a Meta-Baseline tune  -> acc of the tuned head (max-va)
  p4  phase-3b SUN-D EMD tune      -> DeepEMD grid acc of ITS max-va, 1-shot
      (p4_1shot) and 5-shot through SFC (p4_5shot), cached grid protocol

Train and test classes are disjoint draws from one generative family
(``synthetic-local``, class_seed 0 against 1), so the accuracies measure
transfer, not memorization. The configs, data, seeds and evaluations are
JAX's, key for key; as in JAX, the encoder's attention is the einsum path
and the EMD solver ``sinkhorn_detached`` (the configs set neither flag).
The run pins its numerics (``reproducible``): cuDNN's deterministic
algorithms, TF32 off, so that one card type gives one result, as JAX's
programs do on the TPU.

Prints one JSON line {"p0", "p1", "p2", "p3", "p4_1shot", "p4_5shot"}. The
gate is ``tests/test_cli_integration.py::TestLearningQuality``'s asserts.
Scale knobs via env: LPROBE_EPOCHS1/2/3/4, LPROBE_EPISODES, LPROBE_SAVE.

Run:  python -m fewshot_vit_tpu_torch.tools.learning_probe [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from types import SimpleNamespace
from typing import Any, Optional

import numpy as np
import torch

from ..checkpoint.io import load_model
from ..core.config import Config
from ..core.device import resolve_device
from ..core.registry import datasets, models
from ..core.watchdog import watchdog_reexec
from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
from ..data.datasets import ArrayDataset
from ..data.staging import upload_images
from ..eval.emd_eval import (
    group_episode_indices,
    make_emd_cached_episode_fn,
    make_emd_eval_run_fn,
    make_emd_node_cache_fn,
    sample_emd_episode_indices,
)
from ..eval.episodic import evaluate
from ..heads import classifier, deepemd, meta_baseline, token_label  # noqa: F401
from ..train import meta_tune, meta_tune_emd, pretrain, sun
from ..train.meta_tune_emd import make_patch_fn
from ..train.runner import fs_eval
from .precision_check import tf32_off

ENCODER = "visformer_micro_80"
TRAIN_ARGS = {"n_classes": 16, "n_per_class": 200, "image_size": 80, "class_seed": 0, "seed": 0}
# novel classes (class_seed 1): the same family, disjoint identities
TEST_ARGS = {"n_classes": 8, "n_per_class": 40, "image_size": 80, "class_seed": 1, "seed": 9}
EVAL_SEED = 5
SFC_KW = {"steps": 100, "lr": 0.1, "batch_size": 4}
EMD_GROUP = 16  # episodes a batch of the cached EMD protocol


def phase_configs(save_root: str, epochs1: int = 12, epochs2: int = 8, epochs3: int = 3,
                  epochs4: int = 2) -> dict:
    """The four phases' configs as plain dicts, JAX's ``Config({...})``
    literals key for key."""
    enc_name, train_args = ENCODER, dict(TRAIN_ARGS)
    return {
        # p1: CE pretraining (cropaug, cosine-warmup AdamW)
        "p1": {
            "train_dataset": "synthetic-local", "train_dataset_args": train_args,
            "model": "classifier", "model_args": {"encoder": enc_name},
            "batch_size": 128, "max_epoch": epochs1, "image_size": 80,
            "augment": "cropaug",
            "optimizer": "adamw",
            "optimizer_args": {"lr": 1e-3, "weight_decay": 0.05,
                               "schedule": "cosine", "warmup_epochs": 1},
            "eval_fs_epoch": 0,
        },
        # p2: SUN token-label meta-training from the p1 teacher
        "p2": {
            "train_dataset": "synthetic-local", "train_dataset_args": train_args,
            "model": "token-label", "model_args": {"encoder": enc_name},
            "load": os.path.join(save_root, "lp_p1", "epoch-last"),
            "tl_soft_k": 3, "bg_token_num": 10, "token_label_weight": 0.5,
            "batch_size": 128, "max_epoch": epochs2, "image_size": 80,
            "optimizer": "adamw",
            "optimizer_args": {"lr": 5e-4, "weight_decay": 0.05,
                               "schedule": "cosine", "warmup_epochs": 1},
            "eval_fs_epoch": 0,
        },
        # p3: Meta-Baseline episodic tuning from the p2 encoder
        "p3": {
            "train_dataset": "synthetic-local", "train_dataset_args": train_args,
            "val_dataset": "synthetic-local",
            "val_dataset_args": {**train_args, "seed": 4},
            "model": "meta-baseline", "model_args": {"encoder": enc_name},
            "load_encoder": os.path.join(save_root, "lp_p2", "epoch-last"),
            "n_way": 5, "n_shot": 1, "n_query": 10,
            "n_train_way": 5, "n_train_query": 10,
            "ep_per_batch": 4, "train_batches": 50, "max_epoch": epochs3,
            "optimizer": "sgd", "optimizer_args": {"lr": 1e-3},
            "val_episodes": 100,
        },
        # p4: phase-3b SUN-D grid EMD tune from the SAME p2 encoder
        "p4": {
            "train_dataset": "synthetic-local", "train_dataset_args": train_args,
            "val_dataset": "synthetic-local",
            "val_dataset_args": {**train_args, "seed": 4},
            "model_args": {"encoder": enc_name},
            "load_encoder": os.path.join(save_root, "lp_p2", "epoch-last"),
            "way": 5, "shot": 1, "query": 10, "deepemd": "grid",
            "max_epoch": epochs4, "train_batches": 30, "bs": 1,
            "lr": 5e-4, "step_size": 10, "gamma": 0.5, "weight_decay": 5e-4,
            "val_episode": 60, "test_episode": 0,
        },
    }


@contextlib.contextmanager
def reproducible():
    """cuDNN's deterministic algorithms, no autotuning, fp32 products in
    fp32 (TF32 off), restored after. Without it the card's atomics reorder
    sums from run to run, and twelve epochs amplify that: three runs on an
    H100 gave p2 - p1 of -0.042, -0.018 and -0.001 (the gate asks -0.045)."""
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with tf32_off():
            yield
    finally:
        cudnn.deterministic, cudnn.benchmark = flags


def novel_split() -> ArrayDataset:
    return datasets.make("synthetic-local", **TEST_ARGS)


def emd_accs(head, test_ds: ArrayDataset, shot: int, n_episodes: int,
             images_dev: Optional[torch.Tensor] = None) -> np.ndarray:
    """JAX's cached grid protocol on the novel classes: every image's 13
    grid nodes encoded once, then ``n_episodes`` 5-way ``shot``-shot
    15-query episodes (seed 5, 16 a batch), SFC at 5-shot
    (``SFC_KW``, shuffles from seed 5) -> per-episode accuracies."""
    dev = next(head.parameters()).device
    images_dev = upload_images(test_ds.images, dev) if images_dev is None else images_dev
    patch_fn = make_patch_fn("grid", [2, 3], 2.0, 80, False, num_patch=9)
    with torch.no_grad():
        nodes = make_emd_node_cache_fn(head, patch_fn, test_ds.mean, test_ds.std)(images_dev)
        ep_fn = make_emd_cached_episode_fn(head, 5, shot, sfc=shot > 1, sfc_kw=SFC_KW,
                                           seed=EVAL_SEED)
        run_fn = make_emd_eval_run_fn(ep_fn, torch.arange(5, device=dev).repeat(15))
        idx = sample_emd_episode_indices(test_ds, n_episodes, 5, shot + 15, seed=EVAL_SEED)
        idx = torch.from_numpy(group_episode_indices(idx, EMD_GROUP).astype(np.int64)).to(dev)
        return run_fn(nodes, idx).cpu().numpy()[:n_episodes]


def meta_baseline_accs(head, test_ds: ArrayDataset, n_episodes: int,
                       images_dev: Optional[torch.Tensor] = None) -> np.ndarray:
    """p3's protocol: 5-way 1-shot 15-query episodes, 8 a batch, seed 5."""
    return evaluate(head, test_ds, n_episodes=n_episodes, way=5, shot=1, query=15,
                    ep_per_batch=8, seed=EVAL_SEED, images_dev=images_dev,
                    device=next(head.parameters()).device)[2]


def run(save_root: str, epochs1: int = 12, epochs2: int = 8, epochs3: int = 3,
        epochs4: int = 2, n_episodes: int = 200, seed: int = 12345, device: Any = "cuda",
        n_episodes_5shot: Optional[int] = None) -> dict:
    """The four phases and the evaluations -> the six accuracies, rounded to
    4 places. ``n_episodes_5shot`` (default ``n_episodes``) cuts only the
    5-shot SFC evaluation. Runs under ``reproducible()``."""
    dev = resolve_device(device)
    with reproducible():
        return _run(save_root, epochs1, epochs2, epochs3, epochs4, n_episodes, seed, dev,
                    n_episodes_5shot)


def _run(save_root, epochs1, epochs2, epochs3, epochs4, n_episodes, seed, dev,
         n_episodes_5shot) -> dict:
    test_ds = novel_split()
    test_images = upload_images(test_ds.images, dev)
    cfgs = phase_configs(save_root, epochs1, epochs2, epochs3, epochs4)

    def args_for(name):
        return SimpleNamespace(name=name, tag=None, seed=seed, save_root=save_root,
                               profile_dir=None, device=str(dev))

    def enc_acc(enc):
        out = fs_eval(enc, test_ds, n_episodes=n_episodes, shots=(1,), seed=EVAL_SEED,
                      images_dev=test_images)
        return float(out["fsa-1"])

    res = {}
    # p0: the untrained baseline
    res["p0"] = enc_acc(models.make(ENCODER, device=dev, seed=seed))
    # p1: CE pretraining
    state1 = pretrain.main(Config(cfgs["p1"]), args_for("lp_p1"))
    res["p1"] = enc_acc(state1.module.encoder)
    # p2: SUN from the p1 teacher
    state2 = sun.main(Config(cfgs["p2"]), args_for("lp_p2"))
    res["p2"] = enc_acc(state2.module.encoder)
    del state1, state2
    # p3: Meta-Baseline tuning from the p2 encoder, scored from its max-va
    meta_tune.main(Config(cfgs["p3"]), args_for("lp_p3"))
    head3 = load_model(os.path.join(save_root, "lp_p3", "max-va"), device=dev)
    res["p3"] = float(meta_baseline_accs(head3, test_ds, n_episodes, test_images).mean())
    # p4: SUN-D grid EMD tuning from the same p2 encoder, scored from its max-va
    meta_tune_emd.main(Config(cfgs["p4"]), args_for("lp_p4"))
    head4 = load_model(os.path.join(save_root, "lp_p4", "max-va"), device=dev)
    for shot, tag, n in ((1, "p4_1shot", n_episodes),
                         (5, "p4_5shot", n_episodes_5shot or n_episodes)):
        res[tag] = float(emd_accs(head4, test_ds, shot, n, test_images).mean())
    return {k: round(v, 4) for k, v in res.items()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    watchdog_reexec(timeout_s=7200)
    import tempfile

    save_root = os.environ.get("LPROBE_SAVE") or tempfile.mkdtemp(prefix="lprobe_")
    print(json.dumps(run(
        save_root,
        epochs1=int(os.environ.get("LPROBE_EPOCHS1", 12)),
        epochs2=int(os.environ.get("LPROBE_EPOCHS2", 8)),
        epochs3=int(os.environ.get("LPROBE_EPOCHS3", 3)),
        epochs4=int(os.environ.get("LPROBE_EPOCHS4", 2)),
        n_episodes=int(os.environ.get("LPROBE_EPISODES", 200)),
        device=args.device)))


if __name__ == "__main__":
    main()
