"""Seeds and host-side generators (counterpart: ``fewshot_vit_tpu/core/rng.py``).

Episode indices come from ``np_rng`` and must equal the JAX package's bit for
bit, so this is a copy of its numpy half. Parameter init uses explicit
``torch.Generator``s (``models/common.py``), never global torch state.
"""

from __future__ import annotations

import numpy as np

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
