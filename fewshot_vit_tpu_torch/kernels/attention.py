"""Fused multi-head self-attention for short token axes
(counterpart: ``fewshot_vit_tpu/kernels/attention.py``).

``fused_mhsa`` on CUDA tensors launches a hand-written kernel of
``csrc/mhsa.cu`` (sm_90a), which replaces the Pallas TPU kernel
``_mhsa_kernel``. On CPU tensors it computes ``fused_mhsa_reference``, the
plain PyTorch version of the same function: that path exists for the CPU
tests; on the card a kernel runs or the call raises. Both are the
implementations of the custom op ``fewshot_vit_tpu_torch::fused_mhsa``
(``mhsa_op``), which ``torch.export`` keeps as one node of an exported
program, chosen by device when the program runs.

The source holds two routes, and ``mhsa_route`` picks one from dtype and
shape alone: ``tensor_core`` (bf16, T <= 128, hd <= 128: ``mma.sync`` products,
scores in registers) and ``general`` (fp32, or bf16 with longer token axes:
fp32 FMAs on the CUDA cores). ``fused_mhsa(..., route="general")`` or the
``force_route("general")`` context forces the general route, for timing one
against the other. Launches are counted in all and per route.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

MAX_TOKENS = 512
MAX_HEAD_DIM = 128
TC_MAX_TOKENS = 128   # the tensor-core route keeps a whole score row in registers
ROUTES = ("general", "tensor_core")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_forced_route: Optional[str] = None


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
        ctypes.c_int, ctypes.c_int,                      # route, 4-byte accesses
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


def mhsa_route(q: torch.Tensor) -> str:
    """The route ``fused_mhsa`` takes for q (and k, v of its dtype and shape)
    when none is forced: a pure function of dtype and shape."""
    t, hd = q.shape[-2:]
    if q.dtype == torch.bfloat16 and t <= TC_MAX_TOKENS and hd <= MAX_HEAD_DIM:
        return "tensor_core"
    return "general"


def mhsa_vectorized(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor) -> bool:
    """Whether the tensor-core route may move bf16 pairs (4-byte ``cp.async``
    and stores): every pointer 4-byte aligned, every (batch, head, token)
    stride even and hd even. Otherwise it moves single elements."""
    if q.shape[-1] % 2:
        return False
    return all(x.data_ptr() % 4 == 0 and all(s % 2 == 0 for s in x.stride()[:3])
               for x in (q, k, v, out))


@contextlib.contextmanager
def force_route(route: Optional[str]):
    """Within the context every ``fused_mhsa`` call without a ``route``
    argument takes this route (``None``: the default choice)."""
    global _forced_route
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    previous, _forced_route = _forced_route, route
    try:
        yield
    finally:
        _forced_route = previous


def _resolve_route(q: torch.Tensor, route: Optional[str]) -> str:
    route = route or _forced_route
    default = mhsa_route(q)
    if route is None:
        return default
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "tensor_core" and default != "tensor_core":
        raise ValueError(f"the tensor-core route takes bfloat16 with T <= {TC_MAX_TOKENS} "
                         f"and hd <= {MAX_HEAD_DIM}, got {q.dtype} {tuple(q.shape)}")
    return route


def _token_major(q: torch.Tensor) -> torch.Tensor:
    """An uninitialized (B, H, T, hd) tensor laid out (B, T, H, hd) in
    memory: the layout ``attention_core`` reshapes back for free."""
    b, h, t, hd = q.shape
    return torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device).transpose(1, 2)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
            scale: float, route: Optional[str]) -> None:
    """Launch the kernel of ``route`` (None: ``mhsa_route``) on CUDA
    tensors, writing ``out`` (any view with a contiguous last dim) and
    nothing else; the one place that counts launches. The op calls it on a
    buffer of its own; the card checks call it on a NaN-filled one."""
    _check(q, k, v, out)
    b, h, t, hd = q.shape
    route = _resolve_route(q, route)
    vec = route == "tensor_core" and mhsa_vectorized(q, k, v, out)
    strides = (ctypes.c_longlong * 12)(
        *(s for x in (q, k, v, out) for s in x.stride()[:3]))
    err = _mhsa_forward()(
        _DTYPE_CODE[q.dtype], q.device.index, ROUTES.index(route), int(vec),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, t, hd, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mhsa kernel launch failed ({route} route): cudaError {err}")
    fused_mhsa.launches += 1
    fused_mhsa.route_launches[route] += 1


# The op ``torch.ops.fewshot_vit_tpu_torch.fused_mhsa``: opaque to
# ``torch.export``, so an exported program calls it by name and the
# implementation is chosen by the tensors' device when the program runs.
# ``route`` is "" for the default choice. Only CUDA and CPU tensors have an
# implementation; the fake one gives shapes and strides to tracing.
@torch.library.custom_op("fewshot_vit_tpu_torch::fused_mhsa", mutates_args=(),
                         device_types="cuda")
def mhsa_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            route: str) -> torch.Tensor:
    out = _token_major(q)
    _launch(q, k, v, out, scale, route or None)
    return out


@mhsa_op.register_kernel("cpu")
def _mhsa_op_cpu(q, k, v, scale, route):
    return _token_major(q).copy_(fused_mhsa_reference(q, k, v, scale))


@mhsa_op.register_fake
def _mhsa_op_fake(q, k, v, scale, route):
    return _token_major(q)


def fused_mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
               route: Optional[str] = None) -> torch.Tensor:
    """q, k, v (B, H, T, hd) -> (B, H, T, hd) = softmax(q k^T * scale) v,
    through the op ``fewshot_vit_tpu_torch::fused_mhsa``.

    The inputs may be strided views (e.g. heads split out of a packed qkv
    projection) as long as the last dim is contiguous. The result is laid
    out (B, T, H, hd) in memory. CPU tensors take the plain version; CUDA
    tensors launch the kernel of ``route`` (default: ``mhsa_route``, or the
    route of ``force_route``) and add one to ``fused_mhsa.launches`` and to
    ``fused_mhsa.route_launches[route]``, also when the op runs inside an
    exported program.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mhsa runs on CPU or CUDA tensors, not {q.device}")
    route = route or _forced_route
    if route is not None:
        _resolve_route(q, route)  # refuse a bad route before tracing records it
    return mhsa_op(q, k, v, float(scale), route or "")


fused_mhsa.launches = 0
fused_mhsa.route_launches = {route: 0 for route in ROUTES}


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
        # the op's result is token-major: transposed back, it is contiguous
        return fused_mhsa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          scale).transpose(1, 2)
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)
