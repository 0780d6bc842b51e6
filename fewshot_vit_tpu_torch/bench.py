"""Benchmark: full-protocol episodic eval throughput on one card (counterpart:
the repository's ``bench.py``).

Protocol, as ``bench.py`` runs it: 5-way 1-shot 15-query episodes,
MetaBaseline over ``visformer_micro_80`` with bf16 activations and fp32
parameters, BN folded into the weights (``models/fold.py``), every one of an
episode's 80 images re-encoded (no feature caching), 128 episodes a batch,
1024 episodes. One warm pass (seed 1), then the timed pass (seed 2).

One deliberate difference: the encoder runs with ``use_pallas_attn: true``,
so stage 2's attention is the fused-MHSA kernel (``csrc/mhsa.cu``, 2
launches a batch on the tensor-core route); ``bench.py`` leaves it off.

Dataset: the miniImageNet test pickle under ``./materials`` when present,
else a synthetic stand-in at the test split's geometry (20 classes x 600
images, 80x80 uint8, seed 0). Throughput does not depend on the data.

``vs_baseline`` divides by 41.67 episodes/s: ``BASELINE.md``'s target of
10,000 episodes a minute over four devices, per device. It is a target, not a
measurement.

``--int8`` scores the experimental int8 encoder (``models/quant.py``, scales
calibrated on 256 images) under its own metric name, never as the headline.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Run:  python -m fewshot_vit_tpu_torch.bench [--int8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .core.device import resolve_device
from .core.registry import datasets, models
from .core.watchdog import watchdog_reexec
from .data import datasets as _datasets  # noqa: F401  (registers the datasets)
from .data.datasets import ArrayDataset
from .data.staging import upload_images
from .data.transforms import normalize
from .eval.episodic import evaluate
from .heads import meta_baseline as _heads  # noqa: F401  (registers the heads)
from .models.fold import fold_encoder_in_head
from .models.quant import quantize_encoder_in_head

WAY, SHOT, QUERY = 5, 1, 15
EP_PER_BATCH = 128
N_EPISODES = 1024
WARM_SEED, TIMED_SEED = 1, 2
CALIB_IMAGES = 256
# BASELINE.md's north star: 10,000 eval episodes a minute over 4 devices, per device
TARGET_PER_CHIP = 10000.0 / 60.0 / 4.0
METRIC = "eval_episodes_per_sec_per_chip_5way1shot_full_protocol"
UNIT = "episodes/s/chip"
MINI_TEST = "./materials/miniImageNet_category_split_test.pickle"


def bench_split() -> ArrayDataset:
    """The miniImageNet test split when its pickle is under ``./materials``,
    else the synthetic stand-in at its geometry."""
    if os.path.exists(MINI_TEST):
        return datasets.make("mini-imagenet", root_path="./materials", split="test")
    return datasets.make("synthetic", n_classes=20, n_per_class=600, image_size=80, seed=0)


def bench_head(dtype: torch.dtype = torch.bfloat16, use_pallas_attn: bool = True):
    """The bench's MetaBaseline over ``visformer_micro_80``, weights seeded
    (seed 0) and built on the CPU."""
    return models.make("meta-baseline", encoder="visformer_micro_80",
                       encoder_args={"use_pallas_attn": use_pallas_attn}, dtype=dtype,
                       device="cpu", seed=0)


def calibration_batch(ds: ArrayDataset, device: Any) -> torch.Tensor:
    """``bench.py``'s int8 calibration batch: min(256, N) images drawn without
    replacement from ``np.random.default_rng(0)`` (the split is
    class-contiguous, so a prefix would calibrate on about one class), in
    index order, normalized, on ``device``."""
    idx = np.sort(np.random.default_rng(0).choice(
        len(ds.images), size=min(CALIB_IMAGES, len(ds.images)), replace=False))
    return normalize(torch.from_numpy(np.asarray(ds.images[idx])).to(device), ds.mean, ds.std)


def run(int8: bool = False, device: Any = "cuda", n_episodes: int = N_EPISODES,
        ep_per_batch: int = EP_PER_BATCH, dataset: Optional[ArrayDataset] = None,
        make_head: Callable[[], torch.nn.Module] = bench_head
        ) -> Tuple[dict, np.ndarray]:
    """The benchmark: (the result dict, the timed pass's per-episode
    accuracies). ``make_head()`` builds the unfolded head on the CPU; it is
    moved to ``device``, then folded (or folded and quantized, ``int8``)."""
    dev = resolve_device(device)
    ds = dataset if dataset is not None else bench_split()
    head = make_head().to(dev)
    if int8:
        head = quantize_encoder_in_head(head, calib_images=calibration_batch(ds, dev))
    else:
        head = fold_encoder_in_head(head)
    images_dev = upload_images(ds.images, dev)
    kw = dict(n_episodes=n_episodes, way=WAY, shot=SHOT, query=QUERY,
              ep_per_batch=ep_per_batch, images_dev=images_dev, device=dev)
    evaluate(head, ds, seed=WARM_SEED, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, _, accs = evaluate(head, ds, seed=TIMED_SEED, **kw)  # ends in a host fetch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    eps_per_sec = n_episodes / (time.perf_counter() - t0)
    result = {
        "metric": METRIC + ("_int8_experimental" if int8 else ""),
        "value": round(eps_per_sec, 2),
        "unit": UNIT,
        "vs_baseline": round(eps_per_sec / TARGET_PER_CHIP, 3),
    }
    return result, accs


def measure(int8: bool = False, device: Any = "cuda", **sizes) -> dict:
    """The headline benchmark's result dict. The caller owns the hang
    watchdog. ``sizes`` (``n_episodes``, ``ep_per_batch``, ``dataset``,
    ``make_head``) exist for tests at a small size."""
    return run(int8=int8, device=device, **sizes)[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--int8", action="store_true",
                   help="EXPERIMENTAL int8 encoder (models/quant.py); reported under its own "
                        "metric name")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    # past 1500 s the card is hung: fail loudly
    watchdog_reexec(timeout_s=1500)
    print(json.dumps(measure(int8=args.int8, device=args.device)))


if __name__ == "__main__":
    main()
