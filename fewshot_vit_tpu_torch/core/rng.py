"""Seeds and host-side generators (counterpart: ``fewshot_vit_tpu/core/rng.py``).

Episode indices come from ``np_rng`` and must equal the JAX package's bit for
bit, so this is a copy of its numpy half. Parameter init and every random
draw of a training step (dropout and drop-path masks, grid ratios, random
crops) use explicit ``torch.Generator``s, never global torch state; those
streams differ from the JAX package's PRNG by construction.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_SEED = 12345  # the reference's fixed seed


def np_rng(seed: int = DEFAULT_SEED, epoch: int = 0) -> np.random.Generator:
    """Host-side generator for episode sampling / data order.

    The epoch goes into Philox's HIGH key word, not the counter: counter=e
    and counter=e+1 are the SAME stream offset by one 4-value block (near-
    total overlap between epochs), whereas distinct keys are Philox's
    designed independent-stream mechanism. key=[seed, 0] equals
    Philox(key=seed), so epoch-0 streams are unchanged."""
    return np.random.Generator(
        np.random.Philox(key=np.array([seed, epoch], dtype=np.uint64)))


def torch_generator(device, *key: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the integer tuple
    ``key`` (``(seed, epoch, step[, episode, purpose])``), mixed through
    ``np.random.SeedSequence`` so neighbouring keys give unrelated streams."""
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed >> 1)
