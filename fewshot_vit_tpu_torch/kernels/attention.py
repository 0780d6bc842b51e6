"""Fused multi-head self-attention for short token axes
(counterpart: ``fewshot_vit_tpu/kernels/attention.py``).

``fused_mhsa`` on CUDA tensors launches the hand-written kernel in
``csrc/mhsa.cu`` (sm_90a), which replaces the Pallas TPU kernel
``_mhsa_kernel``. On CPU tensors it computes ``fused_mhsa_reference``, the
plain PyTorch version of the same function: that path exists for the CPU
tests; on the card the kernel runs or the call raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

MAX_TOKENS = 512
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_mhsa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Plain version of the kernel's math on (B, H, T, hd): fp32 scores and
    softmax, probabilities cast to the input dtype, fp32 accumulation,
    output in the input dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float())
    return o.to(q.dtype)


@functools.lru_cache(maxsize=1)
def _mhsa_forward():
    from .build import library

    fn = library("mhsa").mhsa_forward
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int,                      # dtype code, device
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_longlong),               # 12 strides
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,                 # scale, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, out) -> None:
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_mhsa takes float32 or bfloat16, not {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"fused_mhsa takes (B, H, T, hd), got {tuple(q.shape)}")
    _, _, t, hd = q.shape
    if not (1 <= t <= MAX_TOKENS and 1 <= hd <= MAX_HEAD_DIM) or q.numel() == 0:
        raise ValueError(f"fused_mhsa takes T <= {MAX_TOKENS} and hd <= "
                         f"{MAX_HEAD_DIM}, got shape {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous, strides {x.stride()}")


def fused_mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v (B, H, T, hd) -> (B, H, T, hd) = softmax(q k^T * scale) v.

    The inputs may be strided views (e.g. heads split out of a packed qkv
    projection) as long as the last dim is contiguous. ``out``, if given,
    is written in place (any view of that shape with a contiguous last dim).
    CPU tensors take the plain version; CUDA tensors launch the kernel and
    add one to ``fused_mhsa.launches``.
    """
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        return out.copy_(fused_mhsa_reference(q, k, v, scale))
    if q.device.type != "cuda":
        raise ValueError(f"fused_mhsa runs on CPU or CUDA tensors, not {q.device}")
    _check(q, k, v, out)
    b, h, t, hd = q.shape
    strides = (ctypes.c_longlong * 12)(
        *(s for x in (q, k, v, out) for s in x.stride()[:3]))
    err = _mhsa_forward()(
        _DTYPE_CODE[q.dtype], q.device.index,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, t, hd, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mhsa kernel launch failed: cudaError {err}")
    fused_mhsa.launches += 1
    return out


fused_mhsa.launches = 0


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   use_pallas: bool = True, max_tokens: int = MAX_TOKENS) -> torch.Tensor:
    """(B, T, H, hd) q, k, v -> (B, T, H, hd) attention output.

    The fused kernel when ``use_pallas`` (the JAX package's name for the
    flag; here it selects the CUDA kernel) and the token axis is at most
    ``max_tokens``; the einsum chain otherwise. The kernel reads the
    (B, T, H, hd) views through their strides, without transposing copies.
    """
    b, t, h, hd = q.shape
    if use_pallas and t <= max_tokens:
        out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
        fused_mhsa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale,
                   out=out.transpose(1, 2))
        return out
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)
