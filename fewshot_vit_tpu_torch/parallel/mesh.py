"""The device mesh over ``torch.distributed`` (counterpart:
``fewshot_vit_tpu/parallel/mesh.py``).

JAX runs one process over N devices and lets XLA place the collectives. The
port runs one process per device, a *rank*, started by ``torchrun
--nproc-per-node N -m fewshot_vit_tpu_torch.<entry> ...``; the collectives
are explicit and few, all in this module:

  * a ``Mesh`` names the axes ``data`` (batch and episode parallelism) and
    ``model`` (column-parallel wide layers). Its size must equal the world
    size: ``data`` varies slowest, as in JAX's process-major device order,
    so rank ``r`` sits at ``data = r // model``, ``model = r % model``;
  * a batch or an episode batch is sharded as this rank's contiguous block
    of its leading axis (``Mesh.block``), everything else is whole on every
    rank (``replicated``);
  * gradients are averaged over the ``data`` group with one flat
    ``all_reduce`` (``Mesh.average``, ``sync_tensors``);
  * under ``use_mesh(mesh)`` a training-mode BatchNorm all-reduces its
    ``(sum x, sum x^2, count)`` over the ``data`` group, so its statistics
    are those of the global batch, as JAX's ``jnp.mean`` over a sharded
    batch axis gives them (``models/common.py::BatchNorm2d``);
  * ``param_shardings`` makes the wide ``Linear`` / ``Conv`` layers
    column-parallel over the ``model`` group (``ColumnParallel``).

Backend: NCCL when every local rank has a card of its own, gloo when ranks
share a card or run on the CPU (gloo is the one backend that puts two ranks
on one card). The collectives used here, ``all_reduce`` and the flat
all-gather, take CUDA tensors on either backend. Like every entry point, a
rank takes the card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..core.device import resolve_device

AXES = ("data", "model")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def rank_device(device) -> torch.device:
    """This rank's device for an entry point's ``--device``: ``cuda`` (no
    index) is ``cuda:{LOCAL_RANK % device_count}``; ``cpu`` stays the CPU.
    Raises, as ``resolve_device`` does, when the card was asked for and
    there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())
    return resolve_device(dev)


def choose_backend(device: torch.device) -> str:
    """``nccl`` when this host's ranks each have a card of their own, else
    ``gloo`` (ranks on the CPU, or several ranks on one card)."""
    local_world = _env_int("LOCAL_WORLD_SIZE", 1)
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> int:
    """Join the process group; returns the world size.

    With ``coordinator_address`` (``host:port`` or ``tcp://host:port``),
    ``num_processes`` and ``process_id`` the group starts from a ``tcp://``
    rendezvous; without them from ``torchrun``'s environment (``env://``).
    A no-op returning 1 for a single process with no coordinator and no
    ``torchrun`` environment, as JAX's. A second call returns the world
    size of the group already joined. ``device`` is this rank's (see
    ``rank_device``): the card unless ``"cpu"`` is asked for."""
    if dist.is_initialized():
        return dist.get_world_size()
    from_env = "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ
    if not coordinator_address and not from_env and (num_processes or 1) <= 1:
        return 1
    dev = rank_device(device)
    backend = choose_backend(dev)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    kw = {}
    if coordinator_address:
        addr = coordinator_address
        kw = {"init_method": addr if "://" in addr else f"tcp://{addr}",
              "world_size": int(num_processes if num_processes is not None
                                else os.environ["WORLD_SIZE"]),
              "rank": int(process_id if process_id is not None else os.environ["RANK"])}
    dist.init_process_group(backend, **kw)
    return dist.get_world_size()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or a process outside any group: the one that writes logs,
    checkpoints and printed lines."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (no-op outside a group): where a later step reads
    what rank 0 wrote."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class Mesh:
    """The port's mesh: axis sizes (``shape``, in order, ``data`` first),
    this rank's coordinates, the process group of each axis through this
    rank (None when the axis has size 1), the device and the backend."""

    def __init__(self, shape: Dict[str, int], device: torch.device):
        self.shape = dict(shape)
        self.device = device
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.backend = dist.get_backend() if dist.is_initialized() else None
        d, m = self.size("data"), self.size("model")
        self.coords = {"data": self.rank // m, "model": self.rank % m}
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {"data": None, "model": None}
        # every rank's device, for rank 0's log line (one all-reduce at start)
        idx = torch.tensor([device.index if device.type == "cuda" else -1], device=device)
        self.rank_devices = [f"cuda:{i}" if i >= 0 else "cpu" for i in all_gather(
            idx, dist.group.WORLD if d * m > 1 else None, d * m).tolist()]
        if d * m > 1:
            # every rank creates every group, in the same order
            for j in range(m):
                g = dist.new_group([i * m + j for i in range(d)]) if d > 1 else None
                if j == self.coords["model"]:
                    self.groups["data"] = g
            for i in range(d):
                g = dist.new_group([i * m + j for j in range(m)]) if m > 1 else None
                if i == self.coords["data"]:
                    self.groups["model"] = g

    def size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def block(self, n: int, axis: str = "data") -> slice:
        """This rank's contiguous block of a leading axis of length ``n``."""
        size = self.size(axis)
        if n % size:
            raise ValueError(f"a leading axis of {n} does not divide over the mesh "
                             f"{axis} axis ({size})")
        b = n // size
        return slice(self.index(axis) * b, (self.index(axis) + 1) * b)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x``'s leading axis (``batch_sharding``)."""
        return x[batch_sharding(self, x.shape[0])]

    def gather(self, x: torch.Tensor, dim: int = 0, axis: str = "data") -> torch.Tensor:
        """The blocks of every rank of ``axis``, concatenated along ``dim``
        in rank order (no gradient)."""
        return all_gather(x, self.groups[axis], self.size(axis), dim)

    def all_reduce(self, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Sum over ``axis`` (no gradient), in place; returns ``x``."""
        if self.groups[axis] is not None:
            reduce_sum_(x, self.groups[axis])
        return x

    def average(self, tensors: Iterable[torch.Tensor], axis: str = "data") -> None:
        """Average ``tensors`` over ``axis``, in place: one flat
        ``all_reduce`` of their concatenation, then ``/ size``."""
        tensors = [t for t in tensors if t is not None]
        if self.groups[axis] is None or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        reduce_sum_(flat, self.groups[axis])
        flat /= self.size(axis)
        for t, chunk in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(chunk.view_as(t))

    def describe(self) -> str:
        """The log line rank 0 prints: world size, axes, each rank's device,
        the backend and why it was chosen."""
        n = int(np.prod(list(self.shape.values())))
        backend = self.backend or "none (one process)"
        why = {"gloo": ", chosen: ranks share a card or run on the CPU",
               "nccl": ", chosen: one card a rank"}.get(self.backend, "")
        return (f"mesh: {self.shape} over {n} process(es), devices by rank "
                f"{self.rank_devices}; backend {backend}{why}")


def make_mesh(axes: Optional[Dict[str, int]] = None, device="cuda") -> Mesh:
    """Build the mesh over the process group (default: a 1-D ``data`` mesh
    over every rank). Joins the group first from ``torchrun``'s environment
    when it is there. The mesh must cover every rank: a smaller world raises
    with JAX's words, a larger one too (JAX would leave devices idle, the
    port would leave processes idle)."""
    dev = rank_device(device)
    init_distributed(device=dev)
    world = world_size()
    if axes is None:
        axes = {"data": world}
    axes = {str(k): int(v) for k, v in dict(axes).items()}
    for k in axes:
        if k not in AXES:
            raise ValueError(f"mesh axis {k!r}: the port's mesh has the axes {AXES}")
    n = int(np.prod(list(axes.values()))) if axes else 1
    if n > world:
        raise ValueError(f"mesh {axes} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(
            f"mesh {axes} needs {n} devices, have {world}: the port runs one process a "
            f"device, so the mesh must cover every process (torchrun --nproc-per-node {n})")
    order = {k: axes[k] for k in AXES if k in axes}
    if list(axes) != list(order):
        raise ValueError(f"mesh {axes}: the 'data' axis comes first, as in JAX's "
                         "process-major order")
    return Mesh(order, dev)


# --- the slicing rules (JAX's shardings) -----------------------------------------
def replicated(mesh: Mesh) -> slice:
    """Whole on every rank."""
    return slice(None)


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's block of a leading (batch or episode) axis of length ``n``."""
    return mesh.block(n)


def episode_shardings(mesh: Mesh, n_episodes: int):
    """(shots, queries): both take this rank's block of the episode axis, so
    an episode's support stays with its queries."""
    return mesh.block(n_episodes), mesh.block(n_episodes)


# --- collectives ------------------------------------------------------------------
_GLOO_TYPES = (torch.float32, torch.float64, torch.int32, torch.int64, torch.uint8)


def reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group``. A bool reduces as int32 (a logical or);
    on gloo, a dtype it does not sum (bf16, fp16) reduces in fp32."""
    if x.dtype == torch.bool:
        wide = x.to(torch.int32)
        dist.all_reduce(wide, group=group)
        return x.copy_(wide > 0)
    if dist.get_backend(group) == "gloo" and x.dtype not in _GLOO_TYPES:
        wide = x.float()
        dist.all_reduce(wide, group=group)
        return x.copy_(wide)
    dist.all_reduce(x, group=group)
    return x


# ``all_gather_into_tensor`` is deprecated under this name from torch 2.13 on
_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(x: torch.Tensor, group, size: int, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order: one
    all-gather into a flat buffer, the output form gloo takes (an ``x`` of
    another shape on another rank raises)."""
    if group is None:
        return x
    buf = torch.empty(size * x.numel(), dtype=x.dtype, device=x.device)
    _gather_flat(buf, x.contiguous().reshape(-1), group=group)
    return torch.cat(buf.view((size,) + tuple(x.shape)).unbind(0), dim=dim)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient of every rank's input is the sum of
    the output gradients (each rank's output feeds its own loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum_(g.clone(), ctx.group), None


class _CopyToRegion(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (the
    input of a column-parallel layer feeds every rank's slice)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum_(g.clone(), ctx.group), None


class _GatherFromRegion(torch.autograd.Function):
    """All-gather along ``dim`` forward; the backward takes this rank's
    slice of the gradient, without communication."""

    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        ctx.index, ctx.dim, ctx.width = index, dim, x.shape[dim]
        return all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width), None, None, None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (identity for None)."""
    return x if group is None else _AllReduceSum.apply(x, group)


# --- the active mesh of a training step ---------------------------------------------
_active: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "fewshot_vit_active_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Within this context the training steps shard their batch over
    ``mesh``'s ``data`` axis, average gradients over it, and training-mode
    BatchNorm uses global-batch statistics. ``None`` changes nothing."""
    token = _active.set(mesh)
    try:
        yield mesh
    finally:
        _active.reset(token)


def data_group():
    """The ``data`` group of the active mesh, or None (no mesh, or size 1)."""
    mesh = _active.get()
    return None if mesh is None else mesh.groups["data"]


def sync_tensors(tensors: Iterable[torch.Tensor]) -> None:
    """Average ``tensors`` in place over the active mesh's ``data`` axis."""
    mesh = _active.get()
    if mesh is not None:
        mesh.average(tensors)


def mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A step's 0-d metrics averaged over the active mesh's ``data`` axis
    (one ``all_reduce``): the global batch's values, as JAX logs them."""
    mesh = _active.get()
    if mesh is None or mesh.groups["data"] is None:
        return metrics
    flat = torch.stack([v.detach().float() for v in metrics.values()])
    mesh.average([flat])
    return dict(zip(metrics, flat.unbind(0)))


def shard_rows(*local_counts: int):
    """(rows, n_global) for ``models.common.draw_rows``: a batch that is the
    concatenation of segments, each of which holds this rank's block of
    its global segment (``local_counts`` rows each), sits at these rows of
    the global concatenation. (None, 0) without a sharded ``data`` axis."""
    mesh = _active.get()
    if mesh is None or mesh.size("data") == 1:
        return None, 0
    d, i = mesh.size("data"), mesh.index("data")
    rows, base = [], 0
    for n in local_counts:
        rows.append(base + i * n + torch.arange(n))
        base += n * d
    return torch.cat(rows), base


def local_block(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``x``'s leading axis under the active mesh."""
    mesh = _active.get()
    return x if mesh is None else mesh.shard(x)


def global_sq_norm(tensors: Iterable[torch.Tensor], params: Iterable[nn.Parameter]) -> torch.Tensor:
    """sum(t^2) over ``tensors`` (one per parameter of ``params``), counting
    a column-parallel parameter's slices once each over its ``model`` group:
    the square of the global norm JAX's ``optax.clip_by_global_norm`` and
    SAM take over the whole tree."""
    whole, sliced, group = 0.0, 0.0, None
    for t, p in zip(tensors, params):
        s = torch.sum(t.float() * t.float())
        tp = getattr(p, "tp", None)
        if tp is None:
            whole = whole + s
        else:
            sliced, group = sliced + s, tp.group
    if group is not None:
        sliced = reduce_sum_(torch.as_tensor(sliced).clone(), group)
    return torch.as_tensor(whole + sliced)


# --- the model axis ------------------------------------------------------------------
class ColumnParallel:
    """Marks a ``Linear`` / ``Conv`` whose output features are sliced over
    the ``model`` group: the rank keeps rows ``[index*w, (index+1)*w)`` of
    the weight (and bias); the forward copies the input into the region,
    runs the local slice and gathers the outputs to the full width along the
    channel (last) axis. A grouped conv with ``groups % size == 0`` also
    takes its block of the input channels and ``groups / size`` groups."""

    def __init__(self, group, size: int, index: int, full_out: int, split_input: bool):
        self.group, self.size, self.index, self.full_out = group, size, index, full_out
        self.split_input = split_input

    def __deepcopy__(self, memo):
        return self  # a copied layer keeps its group and its slice

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToRegion.apply(x, self.group)
        if self.split_input:
            w = x.shape[-1] // self.size
            x = x.narrow(x.dim() - 1, self.index * w, w)
        return x

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        return _GatherFromRegion.apply(y, self.group, self.size, self.index, y.dim() - 1)


def _tp_rule(out_features: int, tp: int, min_features: int) -> bool:
    return tp > 1 and out_features >= min_features and out_features % tp == 0


def param_shardings(mesh: Mesh, module: nn.Module, min_features: int = 256,
                    axis: str = "model") -> List[str]:
    """Make ``module``'s wide layers column-parallel over ``axis``, in place,
    with JAX's rule: a ``Linear`` (JAX's 2-D Dense kernel) or a ``Conv``
    (4-D kernel) whose output features are at least ``min_features`` and
    divide by the axis size keeps only this rank's slice of them; everything
    else stays whole. Returns the names of the sliced layers (none for a
    size-1 axis, where this is pure data parallelism). Call it after the
    weights are loaded: one converted tree serves every layout."""
    from ..models.common import Conv, Linear

    tp = mesh.size(axis)
    index = mesh.index(axis) if axis in mesh.coords else 0
    sliced = []
    for name, m in module.named_modules():
        if not isinstance(m, (Conv, Linear)) or getattr(m, "tp", None) is not None:
            continue
        out = m.weight.shape[0]
        if not _tp_rule(out, tp, min_features):
            continue
        groups = getattr(m, "groups", 1)
        if groups > 1 and groups % tp:
            continue  # its output block would need input channels of other ranks
        w = out // tp
        rows = slice(index * w, (index + 1) * w)
        with torch.no_grad():
            m.weight = nn.Parameter(m.weight[rows].clone())
            if m.bias is not None:
                m.bias = nn.Parameter(m.bias[rows].clone())
        m.tp = ColumnParallel(mesh.groups[axis], tp, index, out, split_input=groups > 1)
        for p in (m.weight, m.bias):
            if p is not None:
                p.tp = m.tp
        if groups > 1:
            m.groups = groups // tp
        sliced.append(name)
    return sliced


def _sliced_params(module: nn.Module) -> Dict[str, ColumnParallel]:
    return {n: p.tp for n, p in module.named_parameters() if getattr(p, "tp", None) is not None}


def gathered_state_dict(module: nn.Module,
                        sd: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """``sd`` (default ``module.state_dict()``) with every column-parallel
    slice gathered back to the full layout: a collective that every rank of
    the ``model`` group calls, so that a checkpoint of a sharded run loads
    into a whole model."""
    sd = module.state_dict() if sd is None else dict(sd)
    for name, tp in _sliced_params(module).items():
        if name in sd:
            sd[name] = all_gather(sd[name], tp.group, tp.size, dim=0)
    return sd


def sliced_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full-layout ``sd`` cut to ``module``'s column-parallel slices."""
    sd = dict(sd)
    for name, tp in _sliced_params(module).items():
        if name in sd and sd[name].shape[0] == tp.full_out:
            w = tp.full_out // tp.size
            sd[name] = sd[name][tp.index * w:(tp.index + 1) * w]
    return sd


def map_optimizer_state(optimizer: torch.optim.Optimizer, state: dict, fn) -> dict:
    """``state`` (an optimizer state dict) with ``fn(tensor, tp)`` applied to
    every per-parameter tensor of a column-parallel parameter (its momentum
    or moments, which have the parameter's shape)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    out = {**state, "state": dict(state["state"])}
    for i, per in state["state"].items():
        tp = getattr(params[int(i)], "tp", None)
        if tp is not None:
            out["state"][i] = {k: fn(v, tp) if torch.is_tensor(v) and v.dim() else v
                               for k, v in per.items()}
    return out
