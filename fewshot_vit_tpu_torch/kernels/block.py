"""NesT's block attention between the qkv and proj projections.

``block_attention`` takes the packed (B, T, N, 3C) output of a NesT layer's
qkv projection (features ordered (3, heads, hd)) and returns the (B, T, N, C)
attention within each of the B * T blocks of N tokens, each head's channels
contiguous (channel = h * hd + d, head-major). The reference merges heads
head-dim-major (channel = d * H + h); ``models/nest.py`` hands the proj
projection its weight with the input columns permuted to match
(``head_major_columns``), the same sum over the same products, so no
permute copy runs between the two.

On CUDA tensors it launches the hand-written kernel of ``csrc/block_attn.cu``
(sm_90a; bf16, at most ``MAX_TOKENS`` tokens a block, head width
``HEAD_DIM``). On CPU tensors it computes ``block_attention_reference``, the
plain PyTorch version of the kernel's numerics. Both are the implementations
of the custom op ``fewshot_vit_tpu_torch::block_attention``
(``block_attention_op``). Launches are counted in ``block_attention.launches``.

No TPU kernel stands behind it: the JAX package runs NesT's attention as
XLA ops. What bounds the kernel on the H100 is bytes (q, k, v read and the
output written once: 9.2 ms for a NesT-T batch of 2,560 images at 3.35 TB/s),
then the exponentials on the special-function units (about 7 ms); the
kernel keeps scores and probabilities in registers, reads each byte of q, k
and v once with 16-byte copies, and writes each output row with 16-byte
stores (the source's note has the rest).
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_TOKENS = 200    # csrc/block_attn.cu keeps at most 25 n-tiles of 8 keys a row
HEAD_DIM = 32       # the head width the source is compiled for: every NesT-T level's


def kernel_takes(dtype: torch.dtype, tokens: int, head_dim: int) -> bool:
    """Whether the kernel takes blocks of ``tokens`` tokens at this head
    width and dtype: bf16, hd 32, 1 to ``MAX_TOKENS`` tokens. The NesTs at hd
    32 have blocks of 196 tokens (NesT-T at 224 px), 25 (the 80 px NesTs)
    and 100 (the 2x last level); at each a layer's span (qkv, attention,
    proj) on the kernel took 0.15-0.16, 0.30 and 0.22 of its time on the
    einsum path (``kernels.bench --only block``, 2,560 images, H100 80GB
    HBM3)."""
    return dtype == torch.bfloat16 and 1 <= tokens <= MAX_TOKENS and head_dim == HEAD_DIM


def head_major_columns(dim: int, heads: int) -> torch.Tensor:
    """The proj weight's input columns in the kernel's merge order:
    ``weight[:, head_major_columns(C, H)]`` takes at column h * hd + d the
    reference's column d * H + h."""
    return torch.arange(dim).reshape(dim // heads, heads).t().reshape(-1)


def block_attention_reference(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Plain version of the kernel's math on (B, T, N, 3C) -> (B, T, N, C):
    fp32 scores and softmax, probabilities cast to the input dtype, fp32
    accumulation, the output in the input dtype with each head's channels
    contiguous."""
    b, t, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = qkv.reshape(b, t, n, 3, heads, c // heads).float().unbind(3)
    s = torch.einsum("btqhd,btkhd->bthqk", q, k) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = torch.einsum("bthqk,btkhd->btqhd", p.float(), v)
    return o.to(qkv.dtype).reshape(b, t, n, c)


@functools.lru_cache(maxsize=1)
def _block_attn_forward():
    from .build import library

    fn = library("block_attn").block_attn_forward
    fn.argtypes = [
        ctypes.c_int,                       # device
        ctypes.c_void_p, ctypes.c_void_p,   # qkv, out
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # blocks, tokens, heads
        ctypes.c_float, ctypes.c_void_p,    # scale, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(qkv: torch.Tensor, out: torch.Tensor, heads: int) -> None:
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"block_attention takes (B, T, N, 3 * heads * hd), got "
                         f"{tuple(qkv.shape)} with {heads} heads")
    b, t, n, c3 = qkv.shape
    c = c3 // 3
    if not kernel_takes(qkv.dtype, n, c // heads):
        raise ValueError(f"the block kernel takes bfloat16, head width {HEAD_DIM} and at most "
                         f"{MAX_TOKENS} tokens a block, got {qkv.dtype}, head width "
                         f"{c // heads}, {n} tokens")
    if tuple(out.shape) != (b, t, n, c) or out.dtype != qkv.dtype:
        raise ValueError(f"out must be {qkv.dtype} {(b, t, n, c)}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    for name, x in (("qkv", qkv), ("out", out)):
        if x.device != qkv.device:
            raise ValueError(f"{name} is on {x.device}, qkv on {qkv.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous, strides {x.stride()}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(qkv: torch.Tensor, out: torch.Tensor, heads: int, scale: float) -> None:
    """Launch the kernel on CUDA tensors, writing ``out`` and nothing else;
    the one place that counts launches. The op calls it on a buffer of its
    own; the card checks call it on a NaN-filled one."""
    _check(qkv, out, heads)
    b, t, n = qkv.shape[:3]
    err = _block_attn_forward()(
        qkv.device.index, qkv.data_ptr(), out.data_ptr(), b * t, n, heads, float(scale),
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"block attention kernel launch failed: cudaError {err}")
    block_attention.launches += 1


def _output(qkv: torch.Tensor) -> torch.Tensor:
    return torch.empty(qkv.shape[:-1] + (qkv.shape[-1] // 3,), dtype=qkv.dtype,
                       device=qkv.device)


# The op ``torch.ops.fewshot_vit_tpu_torch.block_attention``: opaque to
# ``torch.export``; the implementation is chosen by the tensor's device.
@torch.library.custom_op("fewshot_vit_tpu_torch::block_attention", mutates_args=(),
                         device_types="cuda")
def block_attention_op(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    out = _output(qkv)
    _launch(qkv, out, heads, scale)
    return out


@block_attention_op.register_kernel("cpu")
def _block_attention_op_cpu(qkv, heads, scale):
    return block_attention_reference(qkv, heads, scale)


@block_attention_op.register_fake
def _block_attention_op_fake(qkv, heads, scale):
    return _output(qkv)


def block_attention(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """qkv (B, T, N, 3C) -> (B, T, N, C): softmax(q k^T * ``scale``) v
    within each block, head-major; through the op
    ``fewshot_vit_tpu_torch::block_attention``. CPU tensors take the plain
    version; CUDA tensors launch the kernel and add one to
    ``block_attention.launches``."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block_attention runs on CPU or CUDA tensors, not {qkv.device}")
    return block_attention_op(qkv, int(heads), float(scale))


block_attention.launches = 0
