"""Shared pieces of the ``test_torch_*`` parity tests: a narrow Visformer
geometry that still reaches the attention dispatch (img 80 -> stage 2 has
T = 10x10 = 100 tokens), numpy copies of flax trees, non-trivial BN stats,
and the skip for tests that need the card."""

import numpy as np
import pytest
import torch

# narrow widths, full img 80: stage-2 T=100 (hd 16), stage-3 T=25 (hd 32)
SMALL_VISFORMER = dict(img_size=80, init_channels=16, embed_dim=96,
                       depth=(1, 1, 1), num_heads=6)


def numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


def randomize_bn(variables, seed=3):
    """Give every BN non-trivial running stats and affine params (fresh
    stats of mean 0 / var 1 would hide sign and offset faults in a fold)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, dict):
                out[k] = walk(v, p)
                continue
            is_bn = any(s == "bn" or s.startswith("bn") or s.endswith("_bn") for s in p[:-1])
            if k == "mean":
                v = rng.normal(0.0, 0.5, v.shape)
            elif k == "var":
                v = rng.uniform(0.25, 4.0, v.shape)
            elif is_bn and k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif is_bn and k == "bias":
                v = rng.normal(0.0, 0.3, v.shape)
            out[k] = np.asarray(v, np.float32)
        return out

    return {col: walk(tree, ()) for col, tree in variables.items()}


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run python3 chip_smoke.py or pytest -m cuda on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())
