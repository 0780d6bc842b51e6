"""Tests of the port that need the card: the CUDA fused-MHSA and Sinkhorn
kernels against their plain versions, and the encoder's fused-attention and
the DeepEMD head's kernel paths against their plain paths. They import neither JAX nor the JAX package, so they run on a machine
that has only PyTorch:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from fewshot_vit_tpu_torch.heads.deepemd import emd_logits
from fewshot_vit_tpu_torch.kernels import attention as tk
from fewshot_vit_tpu_torch.kernels import sinkhorn as tks
from fewshot_vit_tpu_torch.models.visformer import Visformer
from fewshot_vit_tpu_torch.ops.emd import normalize_weights

from .torch_port_helpers import SMALL_VISFORMER, cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


def _qkv(shape, seed, device, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(64, 6, 100, 42), (32, 6, 25, 85), (4, 2, 512, 128),
                                   (3, 1, 1, 1), (2, 3, 33, 97)])
def test_kernel_matches_plain(cuda_device, dtype, tol, shape):  # noqa: F811
    q, k, v = _qkv(shape, 6, cuda_device, dtype)
    scale = shape[-1] ** -0.5
    before = tk.fused_mhsa.launches
    got = tk.fused_mhsa(q, k, v, scale, out=torch.full_like(q, float("nan")))
    torch.cuda.synchronize()
    assert tk.fused_mhsa.launches == before + 1
    want = tk.fused_mhsa_reference(q, k, v, scale)
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_kernel_reads_strided_views(cuda_device):  # noqa: F811
    b, t, h, hd = 16, 100, 6, 42
    qkv = torch.randn(b, t, 3, h, hd, device=cuda_device)
    q, k, v = qkv.unbind(2)
    got = tk.attention_core(q, k, v, hd ** -0.5)
    want = tk.fused_mhsa_reference(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), hd ** -0.5).transpose(1, 2)
    assert (got - want).abs().max().item() <= 1e-4


def test_kernel_rejects_what_it_cannot_take(cuda_device):  # noqa: F811
    q = torch.zeros(1, 1, 513, 16, device=cuda_device)
    with pytest.raises(ValueError):
        tk.fused_mhsa(q, q, q, 1.0)
    h = torch.zeros(1, 1, 8, 16, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError):
        tk.fused_mhsa(h, h, h, 1.0)
    w = torch.zeros(1, 1, 8, 16, device=cuda_device).transpose(2, 3)
    with pytest.raises(ValueError):
        tk.fused_mhsa(w, w, w, 1.0)


def test_encoder_fused_path_matches_plain(cuda_device):  # noqa: F811
    """Stage 2 (T=100) runs the kernel once per block; fp32 with TF32 off."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 80, 80, 3))
                         .astype(np.float32)).to(cuda_device)
    plain = Visformer(**SMALL_VISFORMER, device=cuda_device, seed=1)
    fused = Visformer(**SMALL_VISFORMER, use_pallas_attn=True, device=cuda_device, seed=1)
    before = tk.fused_mhsa.launches
    with torch.no_grad():
        got, want = fused(x), plain(x)
    torch.cuda.synchronize()
    assert tk.fused_mhsa.launches == before + SMALL_VISFORMER["depth"][1]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _ot_problem(b, n1, n2, seed, device):
    rng = np.random.default_rng(seed)
    cost = torch.from_numpy(rng.uniform(0, 1, (b, n1, n2)).astype(np.float32)).to(device)
    w1, w2 = (normalize_weights(torch.from_numpy(rng.uniform(0, 1, (b, n)).astype(np.float32)))
              .to(device) for n in (n1, n2))
    return cost, w1, w2


@pytest.mark.parametrize("shape,iters", [((3000, 13, 13), 100), ((300, 25, 25), 100),
                                         ((5, 9, 13), 100), ((7, 64, 64), 100),
                                         ((4, 1, 33), 10), ((2, 38, 38), 0)])
def test_sinkhorn_kernel_matches_plain(cuda_device, shape, iters):  # noqa: F811
    cost, w1, w2 = _ot_problem(*shape, seed=sum(shape), device=cuda_device)
    before = tks.sinkhorn_pallas.launches
    got = tks.sinkhorn_pallas(cost, w1, w2, iters=iters,
                              out=torch.full_like(cost, float("nan")))
    torch.cuda.synchronize()
    assert tks.sinkhorn_pallas.launches == before + 1
    want = tks.sinkhorn_reference(cost, w1, w2, iters=iters)
    assert not got.requires_grad
    assert (got - want).abs().max().item() <= 1e-4


def test_sinkhorn_kernel_rejects_what_it_cannot_take(cuda_device):  # noqa: F811
    cost, w1, w2 = _ot_problem(2, 65, 9, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="<= 64"):
        tks.sinkhorn_pallas(cost, w1, w2)
    cost, w1, w2 = _ot_problem(2, 9, 9, seed=0, device=cuda_device)
    with pytest.raises(ValueError):
        tks.sinkhorn_pallas(cost.double(), w1.double(), w2.double())
    with pytest.raises(ValueError):
        tks.sinkhorn_pallas(cost.transpose(1, 2), w1, w2)
    with pytest.raises(ValueError):
        tks.sinkhorn_pallas(cost, w1[:1], w2)


def test_head_kernel_path_matches_plain(cuda_device):  # noqa: F811
    rng = np.random.default_rng(3)
    proto, query = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda_device)
                    for s in ((8, 5, 13, 64), (8, 75, 13, 64)))
    before = tks.sinkhorn_pallas.launches
    got = emd_logits(proto, query, solver_impl="pallas")
    assert tks.sinkhorn_pallas.launches == before + 1
    torch.testing.assert_close(got, emd_logits(proto, query), rtol=1e-4, atol=1e-4)
