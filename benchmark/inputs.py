"""Every input of a run, made from ``--seed`` by the benchmark itself: the
synthetic split at a real split's geometry, the episodes drawn from it, the
weights and BN statistics. The program receives these; the reference reads
the same."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .reference.visformer import Encoder


def generator(device, seed: int, *salt: int) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, salt...)."""
    mixed = np.random.SeedSequence([int(seed) % (1 << 63), *salt]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) >> 1)


def host_rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *salt])


def split(n_classes: int, per_class: int, size: int, seed: int, device) -> torch.Tensor:
    """(n_classes * per_class, size, size, 3) uint8 on ``device``, class c at
    rows [c * per_class, (c + 1) * per_class): a random pattern per class
    plus independent noise in [-40, 40) per image, so that classes are told
    apart even by random weights."""
    gen = generator(device, seed, 1)
    base = torch.randint(0, 256, (n_classes, size, size, 3), generator=gen, device=device,
                         dtype=torch.int16)
    out = torch.empty((n_classes * per_class, size, size, 3), dtype=torch.uint8, device=device)
    for c in range(n_classes):
        noise = torch.randint(-40, 40, (per_class, size, size, 3), generator=gen, device=device,
                              dtype=torch.int16)
        out[c * per_class:(c + 1) * per_class] = (noise + base[c]).clamp_(0, 255).to(torch.uint8)
    return out


def episodes(rng: np.random.Generator, n_episodes: int, n_classes: int, per_class: int,
             way: int, n_per: int) -> np.ndarray:
    """(n_episodes, way, n_per) int64 image indices: ``way`` distinct classes
    and ``n_per`` distinct images of each, per episode."""
    classes = np.argsort(rng.random((n_episodes, n_classes)), axis=1)[:, :way]
    items = np.argpartition(rng.random((n_episodes, way, per_class)), n_per - 1,
                            axis=-1)[..., :n_per]
    return classes[..., None] * per_class + items


def weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
            salt: int = 2) -> Dict[str, torch.Tensor]:
    """fp32 tensors on ``device`` from one normal draw: 4-D kernels Kaiming
    (fan out), 2-D ones std 0.02, positional embeddings std 0.02 clipped at
    two std, biases and BN shifts 0.1 std, BN scales 1 + 0.1 std, running
    statistics 0 and 1 (``calibrate`` sets them), 0-d temperatures 10."""
    total = sum(math.prod(s) for s in shapes.values())
    draw = torch.randn(total, generator=generator(device, seed, salt), device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = draw[at:at + n].reshape(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            t = torch.zeros(shape, device=device)
        elif leaf == "running_var":
            t = torch.ones(shape, device=device)
        elif "pos_embed" in name:
            t = (0.02 * z).clamp(-0.04, 0.04)
        elif len(shape) == 4:
            t = z * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif len(shape) == 2:
            t = 0.02 * z
        elif len(shape) == 0:
            t = torch.full(shape, 10.0, device=device)
        elif leaf == "weight":  # BN scales
            t = 1.0 + 0.1 * z
        else:
            t = 0.1 * z
        out[name] = t.contiguous()
    return out


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """fp32 products without TF32, on the card and in cuDNN."""
    mm, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


@torch.no_grad()
def calibrate(params: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor) -> None:
    """Set every BN's running statistics, in place, to the batch statistics
    of the model inputs ``x`` flowing through the encoder, layer by layer:
    the statistics a trained model holds for inputs like these, so that the
    activations and logits are well conditioned."""
    with exact_fp32():
        enc = Encoder(params, cfg, bn="batch")
        enc(x)
    for k, v in enc.stats.items():
        params[k].copy_(v)
