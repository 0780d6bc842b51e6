"""bf16 against fp32 mean accuracy on the bench's configuration (counterpart:
the repository's ``tools/precision_check.py``).

Runs the protocol ``fewshot_vit_tpu_torch.bench`` measures (5-way 1-shot
15-query full-protocol episodic eval, MetaBaseline over
``visformer_micro_80``, ``use_pallas_attn: true``) twice over identical
parameters (one seeded init, fp32 parameters in both) and identical episodes:
once with fp32 activations (TF32 off), 64 episodes a batch, and once with
bf16 activations, 128 a batch. As in JAX's tool the head is not folded. With
the kernel on, fp32 runs the MHSA kernel's general route and bf16 its
tensor-core route, so the gate also holds the two routes' mean accuracies
to each other. The fp32 pass turns TF32 off through ``torch.backends``; those
flags reach cuBLAS and cuDNN, not a hand-written ``mma``, and the general
route multiplies fp32 on the TF32 tensor cores as 3xTF32 inside the kernel
(each operand split into a TF32 high and low part, three products, each
k-step's sum added in fp32). On the H100 its output sits as close to float64
as the plain fp32 version's (``chip_smoke.py`` phase 4 holds it), so the
fp32 pass stays an fp32 reference for the gate, as on the TPU. Prints one
JSON line with both mean accuracies, their CIs and their gap; the gate
(``tests/test_cli_integration.py::TestPrecisionParity``) asks
``acc_fp32 > 0.3`` and ``abs_diff <= 0.005``.

Run:  python -m fewshot_vit_tpu_torch.tools.precision_check [--device cpu]
(env: PRECHECK_EPISODES, PRECHECK_EPB, PRECHECK_EPB_FP32)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Any, Optional

import torch

from ..core.device import resolve_device
from ..core.registry import datasets, models
from ..core.watchdog import watchdog_reexec
from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
from ..data.datasets import ArrayDataset
from ..data.staging import upload_images
from ..eval.episodic import evaluate, sample_episode_indices
from ..heads import meta_baseline as _heads  # noqa: F401  (registers the heads)

WAY, SHOT, QUERY = 5, 1, 15
SEED = 7


@contextlib.contextmanager
def tf32_off():
    """fp32 products in full fp32 on the card (TF32 off), restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def regroup(idx, ep_per_batch: int, ep_len: int):
    """The same flat episode blocks in batches of ``ep_per_batch``: each row
    of ``idx`` holds consecutive ``ep_len`` blocks, so the reshape regroups
    whole episodes and leaves every episode's content untouched."""
    return idx.reshape(-1, ep_per_batch * ep_len)


def precision_head(dtype: torch.dtype, device: Any):
    return models.make("meta-baseline", encoder="visformer_micro_80",
                       encoder_args={"use_pallas_attn": True}, dtype=dtype, device=device,
                       seed=0)


def run(device: Any = "cuda", n_episodes: int = 512, epb: int = 128, epb_fp32: int = 64,
        dataset: Optional[ArrayDataset] = None, make_head=precision_head) -> dict:
    """Both precisions over one episode draw; returns the printed dict.
    ``dataset`` and ``make_head(dtype, device)`` exist for tests at a small
    size."""
    dev = resolve_device(device)
    ds = dataset if dataset is not None else datasets.make(
        "synthetic", n_classes=20, n_per_class=600, image_size=80, seed=0)
    images_dev = upload_images(ds.images, dev)
    # one draw at the headline geometry, shared by both precisions
    idx = sample_episode_indices(ds, n_episodes, WAY, SHOT + QUERY, epb, seed=SEED)
    ep_len = WAY * (SHOT + QUERY)
    out = {}
    for name, dtype, epb_i, idx_i, ctx in (
            ("fp32", torch.float32, epb_fp32, regroup(idx, epb_fp32, ep_len), tf32_off()),
            ("bf16", torch.bfloat16, epb, idx, contextlib.nullcontext())):
        with ctx:
            acc, ci, _ = evaluate(make_head(dtype, dev), ds, n_episodes=n_episodes, way=WAY,
                                  shot=SHOT, query=QUERY, ep_per_batch=epb_i, seed=SEED,
                                  images_dev=images_dev, indices=idx_i, device=dev)
        out[f"acc_{name}"] = round(float(acc), 6)
        out[f"ci_{name}"] = round(float(ci), 6)
    out["abs_diff"] = round(abs(out["acc_fp32"] - out["acc_bf16"]), 6)
    out["n_episodes"] = n_episodes
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    watchdog_reexec(timeout_s=1800)
    print(json.dumps(run(
        device=args.device,
        n_episodes=int(os.environ.get("PRECHECK_EPISODES", 512)),
        epb=int(os.environ.get("PRECHECK_EPB", 128)),          # the bench's headline (bf16)
        epb_fp32=int(os.environ.get("PRECHECK_EPB_FP32", 64)))))


if __name__ == "__main__":
    main()
