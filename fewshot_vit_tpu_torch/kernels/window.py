"""Swin's shifted-window attention between the qkv and proj projections.

``window_attention`` takes the packed (B, R, R, 3C) output of a Swin block's
qkv projection, computed on the un-rolled, un-partitioned token grid, and
returns the (B, R, R, C) attention output at the same places, ready for the
proj projection: the cyclic shift, the window partition, the relative
position bias, the shifted-window mask (-100 across regions), the softmax,
the reverse and the roll back are all done by addressing. Both projections
act on each token alone, so they commute with the roll and the partition.

On CUDA tensors it launches the hand-written kernel of ``csrc/window_attn.cu``
(sm_90a; bf16, windows of at most ``MAX_TOKENS`` tokens, head width
``HEAD_DIM``). On CPU tensors it computes ``window_attention_reference``,
the plain PyTorch version of the same addressing: gather indices for the
shift, region ids from the rolled coordinates, the bias gathered by relative
offset, fp32 scores and softmax. Both are the implementations of the custom
op ``fewshot_vit_tpu_torch::window_attention`` (``window_attention_op``).
No TPU kernel stands behind it: the JAX package runs this attention as XLA
ops. Launches are counted in ``window_attention.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_TOKENS = 64      # csrc/window_attn.cu pads a window to 64 rows: at most 8 x 8
HEAD_DIM = 32        # the head width the source is compiled for: every Swin-T stage's
MASK = -100.0        # shifted_window_mask's additive value across regions


def kernel_takes(dtype: torch.dtype, tokens: int, head_dim: int) -> bool:
    """Whether the kernel computes windows of ``tokens`` tokens at this head
    width and dtype."""
    return dtype == torch.bfloat16 and tokens <= MAX_TOKENS and head_dim == HEAD_DIM


def window_addressing(res: int, window: int, shift: int):
    """The kernel's index math as tensors, for ``nw = (res // window)^2``
    windows of ``n = window^2`` tokens: ``src`` (nw, n), each token's place on
    the (res, res) grid (the grid rolled by -shift, partitioned); ``rel``
    (n, n), the bias table's row for a (query, key) pair; ``region`` (nw, n),
    each token's region of the rolled grid (all 0 unshifted)."""
    nw = res // window
    i, j = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)                   # token t = i * window + j
    w = torch.arange(nw)
    yr = (w[:, None] * window + i[None, :])               # (wy, t) rolled coordinates
    xr = (w[:, None] * window + j[None, :])               # (wx, t)
    y = (yr + shift) % res
    x = (xr + shift) % res
    src = (y[:, None, :] * res + x[None, :, :]).reshape(nw * nw, window * window)
    off = i * (2 * window - 1) + j
    rel = off[:, None] - off[None, :] + off[-1]
    if shift > 0:
        def side(c):
            return torch.where(c < res - window, 0, torch.where(c < res - shift, 1, 2))
        region = (3 * side(yr)[:, None, :] + side(xr)[None, :, :]).reshape(nw * nw, -1)
    else:
        region = torch.zeros(nw * nw, window * window, dtype=torch.long)
    return src, rel, region


def window_attention_reference(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                               shift: int, scale: float) -> torch.Tensor:
    """Plain version of the kernel's math on (B, R, R, 3C) -> (B, R, R, C):
    each window's tokens gathered from their shifted places, fp32 scores
    plus the gathered bias and -100 across regions, fp32 softmax,
    probabilities cast to the input dtype, fp32 accumulation, the output in
    the input dtype scattered back to the places read."""
    b, res, _, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    src, rel, region = (t.to(qkv.device) for t in window_addressing(res, window, shift))
    x = qkv.reshape(b, res * res, 3, heads, hd)[:, src]          # (b, nw, n, 3, heads, hd)
    q, k, v = x.float().unbind(3)
    s = torch.einsum("bwqhd,bwkhd->bwhqk", q, k) * scale
    s = s + table.float()[rel].permute(2, 0, 1)                  # (heads, n, n)
    s = s + torch.where(region[:, :, None] != region[:, None, :], MASK, 0.0)[None, :, None]
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = torch.einsum("bwhqk,bwkhd->bwqhd", p.float(), v).to(qkv.dtype).reshape(b, -1, c)
    out = torch.empty((b, res * res, c), dtype=qkv.dtype, device=qkv.device)
    out[:, src.reshape(-1)] = o
    return out.reshape(b, res, res, c)


@functools.lru_cache(maxsize=1)
def _window_attn_forward():
    from .build import library

    fn = library("window_attn").window_attn_forward
    fn.argtypes = [
        ctypes.c_int,                                     # device
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qkv, table, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,                  # scale, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(qkv, table, out, heads, window, shift) -> None:
    if qkv.dim() != 4 or qkv.shape[1] != qkv.shape[2] or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"window_attention takes (B, R, R, 3 * heads * hd), got "
                         f"{tuple(qkv.shape)} with {heads} heads")
    b, res, _, c3 = qkv.shape
    c = c3 // 3
    if not kernel_takes(qkv.dtype, window * window, c // heads):
        raise ValueError(f"the window kernel takes bfloat16, windows of at most {MAX_TOKENS} "
                         f"tokens and head width {HEAD_DIM}, got {qkv.dtype}, window "
                         f"{window}, head width {c // heads}")
    if res % window or not 0 <= shift < window or (shift and res == window):
        raise ValueError(f"window {window} with shift {shift} does not tile a {res} grid")
    if tuple(table.shape) != ((2 * window - 1) ** 2, heads) or table.dtype != torch.float32:
        raise ValueError(f"the bias table must be float32 {((2 * window - 1) ** 2, heads)}, "
                         f"got {table.dtype} {tuple(table.shape)}")
    if tuple(out.shape) != (b, res, res, c) or out.dtype != qkv.dtype:
        raise ValueError(f"out must be {qkv.dtype} {(b, res, res, c)}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    for name, t in (("qkv", qkv), ("table", table), ("out", out)):
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, strides {t.stride()}")
    for name, t in (("qkv", qkv), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(qkv: torch.Tensor, table: torch.Tensor, out: torch.Tensor, heads: int, window: int,
            shift: int, scale: float) -> None:
    """Launch the kernel on CUDA tensors, writing ``out`` and nothing else;
    the one place that counts launches. The op calls it on a buffer of its
    own; the card checks call it on a NaN-filled one."""
    _check(qkv, table, out, heads, window, shift)
    b, res = qkv.shape[:2]
    err = _window_attn_forward()(
        qkv.device.index, qkv.data_ptr(), table.data_ptr(), out.data_ptr(),
        b, res, window, shift, heads, float(scale),
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"window attention kernel launch failed: cudaError {err}")
    window_attention.launches += 1


def _output(qkv: torch.Tensor) -> torch.Tensor:
    return torch.empty(qkv.shape[:-1] + (qkv.shape[-1] // 3,), dtype=qkv.dtype,
                       device=qkv.device)


# The op ``torch.ops.fewshot_vit_tpu_torch.window_attention``: opaque to
# ``torch.export``; the implementation is chosen by the tensors' device.
@torch.library.custom_op("fewshot_vit_tpu_torch::window_attention", mutates_args=(),
                         device_types="cuda")
def window_attention_op(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                        shift: int, scale: float) -> torch.Tensor:
    out = _output(qkv)
    _launch(qkv, table, out, heads, window, shift, scale)
    return out


@window_attention_op.register_kernel("cpu")
def _window_attention_op_cpu(qkv, table, heads, window, shift, scale):
    return window_attention_reference(qkv, table, heads, window, shift, scale)


@window_attention_op.register_fake
def _window_attention_op_fake(qkv, table, heads, window, shift, scale):
    return _output(qkv)


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                     shift: int, scale: float) -> torch.Tensor:
    """qkv (B, R, R, 3C) -> (B, R, R, C): the attention of every
    ``window`` x ``window`` window of the grid rolled by -``shift``, with the
    relative position bias ``table`` ((2 window - 1)^2, heads) and, when
    shifted, -100 between tokens of different regions, written back to the
    un-rolled places; through the op ``fewshot_vit_tpu_torch::window_attention``.
    CPU tensors take the plain version; CUDA tensors launch the kernel and
    add one to ``window_attention.launches``."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention runs on CPU or CUDA tensors, not {qkv.device}")
    return window_attention_op(qkv, table.detach().float().contiguous(), int(heads), int(window),
                               int(shift), float(scale))


window_attention.launches = 0
