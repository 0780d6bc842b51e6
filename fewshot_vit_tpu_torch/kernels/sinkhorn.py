"""Fused log-domain Sinkhorn over a flat batch of small OT problems
(counterpart: ``fewshot_vit_tpu/kernels/sinkhorn.py``).

``sinkhorn_pallas`` on CUDA tensors launches a hand-written kernel of
``csrc/sinkhorn.cu`` (sm_90a), which replaces the Pallas TPU kernel
``_sinkhorn_kernel``: every iteration runs on-chip, and device memory sees one
read of the cost and marginals and one write of the flow. On CPU tensors it
computes ``sinkhorn_reference``, the plain PyTorch version of the same math:
that path exists for the CPU tests; on the card a kernel runs or the call
raises. Both are the implementations of the custom op
``fewshot_vit_tpu_torch::sinkhorn_pallas`` (``sinkhorn_op``), which
``torch.export`` keeps as one node of an exported program. The JAX name is
kept so a reader finds the counterpart.

The source holds two routes, and ``sinkhorn_route`` picks one from the shape
alone: ``packed`` (N1, N2 <= 32: ``log_k`` in registers, ``sinkhorn_lanes``
lanes per problem, so two problems share a warp when N1, N2 <= 16) and
``general`` (up to 64 nodes: ``log_k`` in shared memory, one warp per
problem). ``sinkhorn_pallas(..., route="general")`` or the
``force_route("general")`` context forces the general route, for timing one
against the other. Launches are counted in all and per route.

The JAX wrapper pads the batch to its grid block; the kernel takes any batch
size, so there is no padding here.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

from ..ops.emd import sinkhorn

MAX_NODES = 64         # N1, N2 limit of the general route (csrc/sinkhorn.cu kMaxNodes)
PACKED_MAX_NODES = 32  # the packed route keeps one row and one column per lane
ROUTES = ("general", "packed")
_forced_route: Optional[str] = None


def sinkhorn_reference(cost: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                       reg: float = 0.05, iters: int = 100) -> torch.Tensor:
    """Plain version of the kernel's math: ``ops.emd.sinkhorn`` with a
    detached flow (the TPU kernel computes the same function)."""
    return sinkhorn(cost, w1, w2, reg=reg, iters=iters, differentiable=False)


@functools.lru_cache(maxsize=1)
def _sinkhorn_forward():
    from .build import library

    fn = library("sinkhorn").sinkhorn_forward
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int,                       # device, route
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,         # batch, n1, n2
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,    # reg, iters, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(cost, w1, w2, out, reg, iters) -> None:
    if cost.dim() != 3 or cost.numel() == 0:
        raise ValueError(f"sinkhorn_pallas takes a non-empty (B, N1, N2) cost, "
                         f"got {tuple(cost.shape)}")
    b, n1, n2 = cost.shape
    if not (n1 <= MAX_NODES and n2 <= MAX_NODES):
        raise ValueError(f"sinkhorn_pallas takes N1, N2 <= {MAX_NODES}, "
                         f"got {tuple(cost.shape)}")
    for name, t, shape in (("w1", w1, (b, n1)), ("w2", w2, (b, n2)),
                           ("out", out, (b, n1, n2))):
        if t.device != cost.device:
            raise ValueError(f"{name} is on {t.device}, cost on {cost.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for name, t in (("cost", cost), ("w1", w1), ("w2", w2), ("out", out)):
        if t.dtype != torch.float32:
            raise ValueError(f"sinkhorn_pallas takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, strides {t.stride()}")
    if not reg > 0 or iters < 0:
        raise ValueError(f"sinkhorn_pallas takes reg > 0 and iters >= 0, "
                         f"got reg={reg}, iters={iters}")


def sinkhorn_route(n1: int, n2: int) -> str:
    """The route ``sinkhorn_pallas`` takes for (B, n1, n2) problems when none
    is forced: a pure function of the shape."""
    if max(n1, n2) > MAX_NODES:
        raise ValueError(f"sinkhorn_pallas takes N1, N2 <= {MAX_NODES}, got ({n1}, {n2})")
    return "packed" if max(n1, n2) <= PACKED_MAX_NODES else "general"


def sinkhorn_lanes(n1: int, n2: int) -> int:
    """Lanes the packed route gives one problem: 16 (two problems per warp)
    when both sides fit a half-warp, else 32."""
    if max(n1, n2) > PACKED_MAX_NODES:
        raise ValueError(f"the packed route takes N1, N2 <= {PACKED_MAX_NODES}, "
                         f"got ({n1}, {n2})")
    return 16 if max(n1, n2) <= 16 else 32


@contextlib.contextmanager
def force_route(route: Optional[str]):
    """Within the context every ``sinkhorn_pallas`` call without a ``route``
    argument takes this route (``None``: the default choice)."""
    global _forced_route
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    previous, _forced_route = _forced_route, route
    try:
        yield
    finally:
        _forced_route = previous


def _resolve_route(n1: int, n2: int, route: Optional[str]) -> str:
    route = route or _forced_route
    if route is None:
        return sinkhorn_route(n1, n2)
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "packed":
        sinkhorn_lanes(n1, n2)  # raises beyond the packed route's limit
    return route


def _launch(cost: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, out: torch.Tensor,
            reg: float, iters: int, route: Optional[str]) -> None:
    """Launch the kernel of ``route`` (None: ``sinkhorn_route``) on CUDA
    tensors, writing ``out``; the one place that counts launches. The op
    calls it on a buffer of its own; the card checks call it on a
    NaN-filled one."""
    _check(cost, w1, w2, out, reg, iters)
    b, n1, n2 = cost.shape
    route = _resolve_route(n1, n2, route)
    err = _sinkhorn_forward()(
        cost.device.index, ROUTES.index(route), cost.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        out.data_ptr(), b, n1, n2, float(reg), int(iters),
        torch.cuda.current_stream(cost.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sinkhorn kernel launch failed ({route} route): cudaError {err}")
    sinkhorn_pallas.launches += 1
    sinkhorn_pallas.route_launches[route] += 1


# The op ``torch.ops.fewshot_vit_tpu_torch.sinkhorn_pallas``: opaque to
# ``torch.export``, so an exported program calls it by name and the
# implementation is chosen by the tensors' device when the program runs.
# ``route`` is "" for the default choice.
@torch.library.custom_op("fewshot_vit_tpu_torch::sinkhorn_pallas", mutates_args=(),
                         device_types="cuda")
def sinkhorn_op(cost: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, reg: float,
                iters: int, route: str) -> torch.Tensor:
    out = torch.empty(cost.shape, dtype=torch.float32, device=cost.device)
    _launch(cost, w1, w2, out, reg, iters, route or None)
    return out


@sinkhorn_op.register_kernel("cpu")
def _sinkhorn_op_cpu(cost, w1, w2, reg, iters, route):
    return sinkhorn_reference(cost, w1, w2, reg, iters)


@sinkhorn_op.register_fake
def _sinkhorn_op_fake(cost, w1, w2, reg, iters, route):
    return torch.empty(cost.shape, dtype=torch.float32, device=cost.device)


def sinkhorn_pallas(cost: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                    reg: float = 0.05, iters: int = 100,
                    route: Optional[str] = None) -> torch.Tensor:
    """cost (B, N1, N2), w1 (B, N1), w2 (B, N2), float32 -> detached flow
    (B, N1, N2), the drop-in for ``ops.emd.sinkhorn(differentiable=False)``,
    through the op ``fewshot_vit_tpu_torch::sinkhorn_pallas``.

    Inputs may require grad (the SUN-D training forward): they are detached
    and the flow is returned outside the autograd graph, so gradients reach
    the encoder only through the similarity map it is multiplied with. CPU
    tensors take the plain version; CUDA tensors launch the kernel of
    ``route`` (default: ``sinkhorn_route``, or the route of ``force_route``)
    and add one to ``sinkhorn_pallas.launches`` and to
    ``sinkhorn_pallas.route_launches[route]``, also when the op runs inside
    an exported program.
    """
    # the flow is a constant of the graph, as the JAX kernel's stop_gradient
    # makes it: inputs that require grad are read, never differentiated
    cost, w1, w2 = cost.detach(), w1.detach(), w2.detach()
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sinkhorn_pallas runs on CPU or CUDA tensors, not {cost.device}")
    route = route or _forced_route
    if route is not None:
        _resolve_route(*cost.shape[1:], route)  # refuse a bad route before tracing records it
    return sinkhorn_op(cost, w1, w2, float(reg), int(iters), route or "")


sinkhorn_pallas.launches = 0
sinkhorn_pallas.route_launches = {route: 0 for route in ROUTES}
