"""The general route of the fused-MHSA kernel (``csrc/mhsa.cu``,
``mhsa_general_kernel``) modelled in plain torch and held against the TPU
kernel in interpret mode: the CUDA kernel cannot run here, so this checks the
design of its arithmetic, not the kernel (``test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernel against the plain version on the card).

The model does what the kernel does, in the kernel's order:

- fp32 products are 3xTF32: each operand split into hi = x rounded to TF32
  (10 mantissa bits, half away from zero, as ``cvt.rna``) and lo = x - hi,
  which the tensor cores read truncated to TF32; the product is taken as
  lo*hi + hi*lo + hi*hi. bf16 products are exact in fp32. The kernel sums
  each k-step's products from zero on the tensor cores and adds the k-steps
  by fp32 adds, because the tensor cores' own fp32 accumulation truncates;
  the model stands in float64 sums for both, and the kernel comes as close
  to float64 on the card (``chip_smoke.py`` phase 4 prints its distance).
- the row max taken on the raw scores, probabilities 2^(s * c - m * c) times
  1 / sum, c = scale * log2(e);
- T <= 128: the exact max and sum of each row; T > 128: two passes over
  blocks of 64 keys, pass A a running max with the sum rescaled to it,
  pass B the probabilities from the finished max and sum;
- in bf16 the normalised probabilities rounded to bf16 before P.V.

Tolerances are PERF.md's kernel rule: fp32 1e-4, bf16 2e-2. A single TF32
product in fp32 breaks 1e-4: one parametrised case shows it.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.kernels.attention import fused_mhsa as j_fused

torch.set_num_threads(1)

BLOCK_KEYS = 64          # keys a block of the two-pass branch
SINGLE_PASS_TOKENS = 128  # up to this many keys a warp's scores stay in registers
SHAPES = ((2, 6, 100, 42), (1, 6, 196, 128), (1, 2, 512, 128))
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernel rounds hi (and cvt.rna.tf32.f32 does):
    half a unit of the 13 dropped bits added to the magnitude's bit pattern,
    then the 13 bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an fp32 operand: its low 13 bits ignored."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, products: str) -> torch.Tensor:
    """a @ b as the kernel's mma.sync products compute it, rounded to fp32."""
    f = lambda x, y: x.double() @ y.double()  # noqa: E731
    if products == "bf16":
        return f(a, b).float()
    ah, bh = _tf32(a), _tf32(b)
    if products == "1xtf32":
        return f(ah, bh).float()
    al, bl = _tf32_read(a - ah), _tf32_read(b - bh)
    return (f(al, bh) + f(ah, bl) + f(ah, bh)).float()


def general_route_model(q, k, v, scale, products=None):
    """(B, H, T, hd) fp32 or bf16 -> (B, H, T, hd) in the input dtype."""
    bf16 = q.dtype == torch.bfloat16
    products = products or ("bf16" if bf16 else "3xtf32")
    c2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(math.log2(math.e),
                                                                 dtype=torch.float32)

    def exp2(x, mc):  # 2^(x * c2 - mc), the exponent one fused multiply-add
        return torch.exp2((x.double() * c2.double() - mc.double()).float())

    s = _mm(q, k.transpose(-1, -2), products)
    t = s.shape[-1]
    if t <= SINGLE_PASS_TOKENS:
        m = s.amax(-1, keepdim=True)
        l = exp2(s, m * c2).sum(-1, keepdim=True)
    else:
        m = torch.full(s.shape[:-1] + (1,), -math.inf)
        l = torch.zeros_like(m)
        for key0 in range(0, t, BLOCK_KEYS):
            blk = s[..., key0:key0 + BLOCK_KEYS]
            new = torch.maximum(m, blk.amax(-1, keepdim=True))
            l = l * exp2(m, new * c2) + exp2(blk, new * c2).sum(-1, keepdim=True)
            m = new
    p = exp2(s, m * c2) * (1.0 / l)
    if bf16:
        p = p.to(torch.bfloat16)
    return _mm(p, v, products).to(q.dtype)


def _inputs(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_out(shape, dtype):
    """The TPU kernel in interpret mode on the same inputs, as fp32 numpy."""
    q, k, v = (jnp.asarray(x).astype(getattr(jnp, dtype)) for x in _inputs(shape, dtype))
    out = j_fused(q, k, v, shape[-1] ** -0.5, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _model_err(shape, dtype, products=None):
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in _inputs(shape, dtype))
    got = general_route_model(q, k, v, shape[-1] ** -0.5, products)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    return float(np.abs(got.float().numpy() - _jax_out(shape, dtype)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_general_route_model_matches_the_tpu_kernel(shape, dtype):
    """(2, 6, 100, 42): visformer stage 2, one pass; (1, 6, 196, 128):
    visformer_small's stage 3 at 224 px, and (1, 2, 512, 128), the longest
    token axis: two passes over 64-key blocks."""
    err = _model_err(shape, dtype)
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("products,holds", [("3xtf32", True), ("1xtf32", False)])
def test_one_tf32_product_breaks_the_fp32_rule(products, holds):
    """At the stage-2 shape 3xTF32 holds the 1e-4 rule and one TF32 product
    per mma does not: the reason the fp32 products are split."""
    err = _model_err(SHAPES[0], "float32", products)
    assert (err <= TOL["float32"]) is holds, err
