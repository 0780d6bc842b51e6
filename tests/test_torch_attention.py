"""Port parity, fused MHSA: the plain version against the Pallas kernel in
interpret mode, and ``attention_core``'s dispatch. The CUDA kernel itself is
held against the plain version on the card by ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.kernels.attention import attention_core as j_core
from fewshot_vit_tpu.kernels.attention import fused_mhsa as j_fused
from fewshot_vit_tpu_torch.kernels import attention as tk

torch.set_num_threads(1)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def test_plain_matches_pallas_interpret():
    b, h, t, hd = 3, 6, 100, 42  # visformer stage-2 geometry, as tests/test_kernels.py
    q, k, v = _qkv((b, h, t, hd), 2)
    scale = hd ** -0.5
    want = np.asarray(j_fused(*map(jnp.asarray, (q, k, v)), scale, interpret=True))
    got = tk.fused_mhsa(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # fp32, different sum order


@pytest.mark.parametrize("use_pallas,t", [(True, 100), (True, 25), (False, 100), (True, 600)])
def test_attention_core_matches_jax(use_pallas, t):
    b, h, hd = 2, 6, 16
    q, k, v = _qkv((b, t, h, hd), 3)
    scale = hd ** -0.5
    want = np.asarray(j_core(*map(jnp.asarray, (q, k, v)), scale, use_pallas=use_pallas))
    before = tk.fused_mhsa.launches
    got = tk.attention_core(*map(torch.from_numpy, (q, k, v)), scale, use_pallas=use_pallas)
    assert got.shape == (b, t, h, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert tk.fused_mhsa.launches == before  # CPU tensors never launch the kernel


def test_strided_views_and_out():
    """Heads split out of a packed qkv tensor, as the Visformer hands them over."""
    b, t, h, hd = 2, 100, 6, 42
    qkv = torch.from_numpy(np.random.default_rng(4).normal(size=(b, t, 3, h, hd)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    got = tk.attention_core(q, k, v, hd ** -0.5)
    want = tk.fused_mhsa_reference(*(x.transpose(1, 2).contiguous() for x in (q, k, v)), hd ** -0.5)
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=0, atol=0)


def test_plain_bf16_rounds_probabilities():
    """In bf16 the probabilities are cast to bf16 before p @ v, as the TPU kernel does."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv((1, 2, 25, 85), 5))
    got = tk.fused_mhsa_reference(q, k, v, 85 ** -0.5)
    assert got.dtype == torch.bfloat16
    s = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * 85 ** -0.5, -1)
    want = (s.to(torch.bfloat16).float() @ v.float()).to(torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
