"""Datasets as in-memory uint8 arrays + labels (counterpart:
``fewshot_vit_tpu/data/datasets.py``).

Every dataset is an ``ArrayDataset``: uint8 images (N, H, W, 3), int32
labels, ``n_classes``, normalization stats. Each loader reads the
reference's on-disk format and gives the JAX package's loader's bytes:

  * ``mini-imagenet``: ``miniImageNet_category_split_{split}.pickle``;
  * ``tiered-imagenet``: ``{split}_images.npz`` + ``{split}_labels.pkl``,
    BGR -> RGB, optional ``mini=True`` 64-class / 600-image subsample;
  * ``cifar-fs``: folder tree ``meta-{split}/<class>/*.png``, CIFAR stats;
  * ``image-folder``: ``images/<class>/*`` listed by a ``split.json``, with
    an optional read-only memmap cache (ImageNet-800 scale);
  * ``fc100``: ``{split}/<class>/*``; ``cub``: ``split/{split}.csv``;
  * ``synthetic`` and ``synthetic-local``: generated from a seed.

The geometry ``protocol`` is applied once at load (``apply_geometry``).
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass, field

import numpy as np

from ..core.registry import datasets
from .transforms import CIFAR_MEAN, CIFAR_STD, MEAN, STD, resize_center_crop, resize_short

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


@datasets.register("tiered-imagenet")
def tiered_imagenet(
    root_path: str = DEFAULT_ROOT,
    split: str = "train",
    image_size: int = 80,
    protocol: str = "resize_crop",
    mini: bool = False,
    **_: object,
) -> ArrayDataset:
    """``{split}_images.npz`` (BGR, flipped to RGB) + ``{split}_labels.pkl``;
    ``mini=True`` keeps 64 classes drawn by ``RandomState(0)`` and their
    first 600 images each (reference ``tiered_imagenet.py:126-161``)."""
    images = np.load(os.path.join(root_path, f"{split}_images.npz"))["images"]
    images = images[:, :, :, ::-1]
    with open(os.path.join(root_path, f"{split}_labels.pkl"), "rb") as f:
        pack = pickle.load(f, encoding="latin1")
    labels = np.asarray(pack["labels"], np.int64)
    labels = labels - labels.min()
    if mini:
        rng = np.random.RandomState(0)
        classes = rng.choice(int(labels.max()) + 1, 64, replace=False)
        keep, new_labels = [], []
        for new_c, c in enumerate(sorted(classes)):
            idx = np.where(labels == c)[0][:600]
            keep.append(idx)
            new_labels.append(np.full(len(idx), new_c, np.int64))
        keep = np.concatenate(keep)
        images, labels = images[keep], np.concatenate(new_labels)
    images = apply_geometry(np.ascontiguousarray(images), image_size, protocol)
    return ArrayDataset(images, labels.astype(np.int32), int(labels.max()) + 1)


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _class_folders(split_dir: str, classes):
    paths, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(split_dir, cname)
        for fname in sorted(os.listdir(cdir)):
            paths.append(os.path.join(cdir, fname))
            labels.append(ci)
    return paths, np.asarray(labels, np.int32)


@datasets.register("cifar-fs")
def cifar_fs(
    root_path: str = DEFAULT_ROOT,
    split: str = "train",
    image_size: int = 80,
    protocol: str = "resize",
    **_: object,
) -> ArrayDataset:
    """``meta-{split}/<class>/*.png`` (reference ``cifar_fs.py:99-140``): the
    32px sources resized to ``image_size`` by default (``protocol='raw'``
    keeps them for device-side augmentation), CIFAR normalization stats."""
    split_dir = os.path.join(root_path, f"meta-{split}")
    classes = sorted(os.listdir(split_dir))
    paths, labels = _class_folders(split_dir, classes)
    images = apply_geometry(np.stack([_read_rgb(p) for p in paths]), image_size, protocol)
    return ArrayDataset(images, labels, len(classes), mean=CIFAR_MEAN, std=CIFAR_STD)


def _load_images_threaded(paths, load_fn, image_size: int) -> np.ndarray:
    """Decode and resize a list of paths into one (N, S, S, 3) uint8 array
    with a thread pool (PIL releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    out = np.empty((len(paths), image_size, image_size, 3), np.uint8)

    def work(i):
        out[i] = load_fn(paths[i])

    with ThreadPoolExecutor(max_workers=16) as pool:
        list(pool.map(work, range(len(paths))))
    return out


@datasets.register("image-folder")
def image_folder(
    root_path: str = DEFAULT_ROOT,
    split: str = "train",
    image_size: int = 80,
    split_file: str = "split.json",
    cache_memmap: bool = False,
    **_: object,
) -> ArrayDataset:
    """``images/<class>/*`` for the classes ``split_file`` lists under
    ``split`` (reference ``image_folder.py:12-67``), Resize(image_size + 8)
    + CenterCrop(image_size). ``cache_memmap=True`` saves the decoded array
    as ``_cache_{split}_{image_size}.npy`` beside the images and returns it
    as a read-only memmap (``staging.memmap_cache``); a cache whose length
    disagrees with the file list raises."""
    from .staging import memmap_cache

    with open(os.path.join(root_path, split_file)) as f:
        split_classes = json.load(f)[split]
    paths, labels = _class_folders(os.path.join(root_path, "images"), split_classes)
    cache_path = os.path.join(root_path, f"_cache_{split}_{image_size}.npy")
    if cache_memmap and os.path.exists(cache_path):
        images = memmap_cache(cache_path)
        if len(images) != len(paths):
            raise ValueError(f"stale cache {cache_path}: {len(images)} imgs vs "
                             f"{len(paths)} files")
    else:
        images = _load_images_threaded(
            paths, lambda p: resize_center_crop(_read_rgb(p), image_size + 8, image_size),
            image_size)
        if cache_memmap:
            images = memmap_cache(cache_path, images)
    return ArrayDataset(images, labels, len(split_classes))


def _load_one(image_size: int, protocol: str):
    return lambda p: apply_geometry(_read_rgb(p)[None], image_size, protocol)[0]


@datasets.register("fc100")
def fc100(
    root_path: str = DEFAULT_ROOT,
    split: str = "train",
    image_size: int = 80,
    protocol: str = "resize_crop",
    **_: object,
) -> ArrayDataset:
    """Class-folder tree ``{split}/<class>/*`` (reference
    ``fc100/fcn/fc100.py:12-39``)."""
    split_dir = os.path.join(root_path, split)
    classes = [d for d in sorted(os.listdir(split_dir))
               if os.path.isdir(os.path.join(split_dir, d))]
    paths, labels = _class_folders(split_dir, classes)
    images = _load_images_threaded(paths, _load_one(image_size, protocol), image_size)
    return ArrayDataset(images, labels, len(classes))


@datasets.register("cub")
def cub(
    root_path: str = DEFAULT_ROOT,
    split: str = "train",
    image_size: int = 80,
    protocol: str = "resize_crop",
    **_: object,
) -> ArrayDataset:
    """CUB with ``split/{split}.csv`` rows ``path,wnid`` (reference
    ``cub/fcn/cub.py:12-40``), including its drop of the broken train image
    at data line 5864."""
    with open(os.path.join(root_path, "split", f"{split}.csv")) as f:
        lines = [x.strip() for x in f.readlines()][1:]
    if split == "train" and len(lines) > 5864:
        lines.pop(5864)
    paths, labels, wnids = [], [], {}
    for line in lines:
        name, wnid = line.split(",")[:2]
        labels.append(wnids.setdefault(wnid, len(wnids)))
        paths.append(os.path.join(root_path, name))
    images = _load_images_threaded(paths, _load_one(image_size, protocol), image_size)
    return ArrayDataset(images, np.asarray(labels, np.int32), len(wnids))


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


@datasets.register("synthetic-local")
def synthetic_local(
    n_classes: int = 16,
    n_per_class: int = 40,
    image_size: int = 80,
    patch_size: int = 24,
    seed: int = 0,
    class_seed: int = 0,
    **_: object,
) -> ArrayDataset:
    """Localized-signal synthetic task: each class is a smooth
    ``patch_size`` x ``patch_size`` colour pattern pasted at a random place
    on iid noise, so an untrained encoder sits near chance and training has
    to learn localized detectors. ``class_seed`` draws the patterns apart
    from the samples (``class_seed=1``: disjoint novel classes)."""
    rng = np.random.default_rng(seed)
    crng = np.random.default_rng((class_seed + 1) * 7919)
    lowres = crng.integers(0, 256, (n_classes, 4, 4, 3)).astype(np.float32)
    reps = -(-patch_size // 4)
    patterns = np.repeat(np.repeat(lowres, reps, 1), reps, 2)[
        :, :patch_size, :patch_size].astype(np.uint8)
    n = n_classes * n_per_class
    labels = np.repeat(np.arange(n_classes), n_per_class)
    images = rng.integers(0, 256, (n, image_size, image_size, 3), dtype=np.uint8)
    ys = rng.integers(0, image_size - patch_size + 1, n)
    xs = rng.integers(0, image_size - patch_size + 1, n)
    for i in range(n):
        images[i, ys[i]: ys[i] + patch_size, xs[i]: xs[i] + patch_size] = patterns[labels[i]]
    return ArrayDataset(images, labels.astype(np.int32), n_classes)
