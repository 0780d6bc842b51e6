"""Run logging, metric averaging, timing (counterpart:
``fewshot_vit_tpu/core/log.py``): a text log (``log.txt``) and a JSON-lines
metric stream (``metrics.jsonl``) per run directory, and sample-grid PNGs
(``visualize_dataset`` / ``image_grid``)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class Averager:
    """Running weighted mean."""

    def __init__(self) -> None:
        self.n = 0.0
        self.v = 0.0

    def add(self, v: float, n: float = 1.0) -> None:
        self.v = (self.v * self.n + float(v) * n) / (self.n + n)
        self.n += n

    def item(self) -> float:
        return self.v


class Timer:
    def __init__(self) -> None:
        self.v = time.time()

    def s(self) -> None:
        self.v = time.time()

    def t(self) -> float:
        return time.time() - self.v


def time_str(t: float) -> str:
    if t >= 3600:
        return f"{t / 3600:.1f}h"
    if t >= 60:
        return f"{t / 60:.1f}m"
    return f"{t:.1f}s"


def compute_n_params(module, return_str: bool = True):
    """Total parameter count of an ``nn.Module`` (or an iterable of tensors),
    optionally as the reference's '12.4M' string."""
    params = module.parameters() if hasattr(module, "parameters") else module
    tot = int(sum(p.numel() for p in params))
    if not return_str:
        return tot
    return f"{tot / 1e6:.1f}M" if tot >= 1e6 else f"{tot / 1e3:.1f}K"


class RunLogger:
    """Text log + JSONL metric stream for one training/eval run."""

    def __init__(self, save_dir: Optional[str] = None, stdout: bool = True):
        self.save_dir = save_dir
        self.stdout = stdout
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)

    def log(self, msg: str) -> None:
        if self.stdout:
            print(msg, flush=True)
        if self.save_dir is not None:
            with open(os.path.join(self.save_dir, "log.txt"), "a") as f:
                print(msg, file=f)

    def visualize_dataset(self, dataset, name: str, n_samples: int = 16,
                          seed: int = 0) -> Optional[str]:
        """Save a grid PNG of ``n_samples`` random images of ``dataset``
        (reference ``utils.visualize_dataset``: tensorboard images become an
        on-disk grid), ``visualize_<name>.png``, the JAX package's draw of
        ``np.random.default_rng(seed)``. Returns the written path."""
        if self.save_dir is None:
            return None
        import numpy as np

        rng = np.random.default_rng(seed)
        idx = rng.choice(len(dataset), min(n_samples, len(dataset)), replace=False)
        return self.image_grid(f"visualize_{name}", np.asarray(dataset.images[np.sort(idx)]))

    def image_grid(self, name: str, imgs_u8) -> Optional[str]:
        """Write a square grid PNG of (N, H, W, 3) uint8 images into the run
        directory as ``<name>.png``, row-major, ceil(sqrt(N)) columns.
        Returns the written path."""
        if self.save_dir is None:
            return None
        import numpy as np
        from PIL import Image

        imgs = np.asarray(imgs_u8, np.uint8)
        cols = int(np.ceil(np.sqrt(len(imgs))))
        rows = int(np.ceil(len(imgs) / cols))
        h, w = imgs.shape[1:3]
        grid = np.zeros((rows * h, cols * w, 3), np.uint8)
        for i, im in enumerate(imgs):
            r, c = divmod(i, cols)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
        path = os.path.join(self.save_dir, f"{name}.png")
        Image.fromarray(grid).save(path)
        return path

    def metrics(self, step: int, **values: Any) -> None:
        if self.save_dir is None:
            return
        rec: Dict[str, Any] = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        with open(os.path.join(self.save_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
