"""Datasets as in-memory uint8 arrays + labels (counterpart:
``fewshot_vit_tpu/data/datasets.py``).

Every dataset is an ``ArrayDataset``: uint8 images (N, H, W, 3), int32
labels, ``n_classes``. ``synthetic`` is byte-identical to the JAX package's
from the same seed; ``mini_imagenet`` reads the reference's pickles and
applies the JAX loader's geometry ``protocol``.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field

import numpy as np

from ..core.registry import datasets
from .transforms import MEAN, STD, resize_center_crop, resize_short

DEFAULT_ROOT = "./materials"


@dataclass
class ArrayDataset:
    images: np.ndarray  # uint8 (N, H, W, 3)
    labels: np.ndarray  # int32 (N,)
    n_classes: int
    mean: np.ndarray = field(default_factory=lambda: MEAN)
    std: np.ndarray = field(default_factory=lambda: STD)

    def __len__(self) -> int:
        return len(self.images)


def apply_geometry(images: np.ndarray, image_size: int, protocol: str) -> np.ndarray:
    """The load-time geometry of ``protocol``: ``raw`` keeps the native
    resolution (device-side augmentation does the geometry), ``resize_crop``
    is Resize(image_size + 8) + CenterCrop(image_size), any other value
    (``resize_short``) Resize(image_size) of the short side. Images already
    at (image_size, image_size) are kept."""
    if protocol == "raw" or images.shape[1:3] == (image_size, image_size):
        return images
    from concurrent.futures import ThreadPoolExecutor

    if protocol == "resize_crop":
        fn = lambda im: resize_center_crop(im, image_size + 8, image_size)  # noqa: E731
    else:
        fn = lambda im: resize_short(im, image_size)  # noqa: E731
    # PIL resize releases the GIL, so threads scale the one-time load
    with ThreadPoolExecutor(max_workers=8) as pool:
        return np.stack(list(pool.map(fn, images)))


@datasets.register("mini-imagenet")
def mini_imagenet(
    root_path: str = DEFAULT_ROOT,
    split: str = "train",
    image_size: int = 80,
    protocol: str = "resize_crop",
    **_: object,
) -> ArrayDataset:
    """``miniImageNet_category_split_{split}.pickle`` (train -> train_phase_train),
    under the geometry ``protocol`` (``apply_geometry``)."""
    split_tag = "train_phase_train" if split == "train" else split
    path = os.path.join(root_path, f"miniImageNet_category_split_{split_tag}.pickle")
    with open(path, "rb") as f:
        pack = pickle.load(f, encoding="latin1")
    images = np.asarray(pack["data"], np.uint8)
    labels = np.asarray(pack["labels"], np.int64)
    labels = labels - labels.min()
    images = apply_geometry(images, image_size, protocol)
    return ArrayDataset(images, labels.astype(np.int32), int(labels.max()) + 1)


@datasets.register("synthetic")
def synthetic(
    n_classes: int = 20,
    n_per_class: int = 40,
    image_size: int = 80,
    seed: int = 0,
    **_: object,
) -> ArrayDataset:
    """Deterministic class-structured random images for tests and benchmarks.

    Each class has a random base pattern; samples are noisy copies, so metric
    heads achieve above-chance accuracy.
    """
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n_classes, image_size, image_size, 3), dtype=np.int16)
    noise = rng.integers(
        -40, 40, (n_classes * n_per_class, image_size, image_size, 3), dtype=np.int16
    )
    labels = np.repeat(np.arange(n_classes), n_per_class)
    noise += base[labels]
    images = np.clip(noise, 0, 255, out=noise).astype(np.uint8)
    return ArrayDataset(images, labels.astype(np.int32), n_classes)
