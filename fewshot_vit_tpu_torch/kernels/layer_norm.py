"""LayerNorm over the last axis from bf16 to bf16 in one pass.

``layer_norm(x, weight, bias, eps)`` computes flax's ``LayerNorm`` as
``models/common.py::LayerNorm`` does: fp32 mean and biased variance, fp32
affine with the fp32 ``weight`` and ``bias``, one rounding to the output
dtype. On CUDA tensors it launches the hand-written kernel of
``csrc/layer_norm.cu`` (sm_90a; bf16 in and out, contiguous rows, widths a
multiple of 8 up to ``MAX_WIDTH``): the row read once as bf16, the
statistics and the affine in registers, bf16 written once, where the plain
version makes three passes through fp32 buffers. On CPU tensors it computes
``layer_norm_reference``, the plain version. Both are the implementations
of the custom op ``fewshot_vit_tpu_torch::layer_norm`` (``layer_norm_op``).
No TPU kernel stands behind it: the JAX package leaves LayerNorm to XLA.
Launches are counted in ``layer_norm.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

MAX_WIDTH = 2048  # csrc/layer_norm.cu: up to 8 vectors of 8 values on each of a warp's lanes
VECTOR = 8        # bf16 values in the kernel's 16-byte loads and stores


def kernel_takes(dtype: torch.dtype, out_dtype: torch.dtype, c: int, contiguous: bool) -> bool:
    """Whether the kernel normalises rows of width ``c`` from ``dtype`` to
    ``out_dtype``; ``contiguous``: the rows packed at stride ``c`` from a
    16-byte aligned start."""
    return (dtype == out_dtype == torch.bfloat16 and contiguous and c % VECTOR == 0
            and VECTOR <= c <= MAX_WIDTH)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """The plain version: fp32 LayerNorm of ``x`` cast up, cast to ``dtype``."""
    return F.layer_norm(x.float(), weight.shape, weight, bias, eps).to(dtype)


@functools.lru_cache(maxsize=1)
def _layer_norm_forward():
    from .build import library

    fn = library("layer_norm").layer_norm_forward
    fn.argtypes = [
        ctypes.c_int,                                                       # device
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, w, b, y
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,   # rows, c, eps, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(x, weight, bias, out) -> None:
    c = x.shape[-1] if x.dim() else 0
    aligned = x.is_contiguous() and x.data_ptr() % 16 == 0
    if not kernel_takes(x.dtype, out.dtype, c, aligned):
        raise ValueError(f"the LayerNorm kernel takes contiguous, 16-byte aligned bfloat16 rows "
                         f"of a width that is a multiple of {VECTOR} up to {MAX_WIDTH}, to "
                         f"bfloat16; got {x.dtype} {tuple(x.shape)} (contiguous "
                         f"{x.is_contiguous()}, aligned {x.data_ptr() % 16 == 0}) to {out.dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if tuple(t.shape) != (c,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 ({c},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if out.shape != x.shape or not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError(f"out must be contiguous, 16-byte aligned {tuple(x.shape)}, got "
                         f"{tuple(out.shape)}")
    for name, t in (("weight", weight), ("bias", bias), ("out", out)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out: torch.Tensor,
            eps: float) -> None:
    """Launch the kernel on CUDA tensors, writing ``out`` and nothing else;
    the one place that counts launches. The op calls it on a buffer of its
    own; the card checks call it on a NaN-filled one."""
    _check(x, weight, bias, out)
    c = x.shape[-1]
    err = _layer_norm_forward()(
        x.device.index, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        x.numel() // c, c, float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"LayerNorm kernel launch failed: cudaError {err}")
    layer_norm.launches += 1


# The op ``torch.ops.fewshot_vit_tpu_torch.layer_norm``: opaque to
# ``torch.export``; the implementation is chosen by the tensors' device.
@torch.library.custom_op("fewshot_vit_tpu_torch::layer_norm", mutates_args=(),
                         device_types="cuda")
def layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    _launch(x, weight, bias, out, eps)
    return out


@layer_norm_op.register_kernel("cpu")
def _layer_norm_op_cpu(x, weight, bias, eps):
    return layer_norm_reference(x, weight, bias, eps, x.dtype)


@layer_norm_op.register_fake
def _layer_norm_op_fake(x, weight, bias, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm of ``x`` over its last axis with the fp32 ``weight`` and
    ``bias``, output in ``x``'s dtype, through the op
    ``fewshot_vit_tpu_torch::layer_norm``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise where it does not take
    them) and add one to ``layer_norm.launches``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"layer_norm runs on CPU or CUDA tensors, not {x.device}")
    return layer_norm_op(x, weight.detach().float().contiguous(),
                         bias.detach().float().contiguous(), float(eps))


layer_norm.launches = 0
