"""Entry points: a forward of the flagship model and the multi-device
dryrun (counterpart: the repository's ``__graft_entry__.py``).

``entry()``              the eval-mode forward of MetaBaseline over
                         ``visformer_micro_80`` and its inputs.
``dryrun_multichip(n)``  five sharding patterns, one step each on tiny
                         shapes, over ``n`` ranks of ``parallel/mesh.py``
                         (one process a device):
                         1. the SUN step on ``{data: n/tp, model: tp}`` (tp 2
                            when n is even): frozen teacher forward, student
                            forward and backward, AdamW, global BN statistics,
                            data-parallel batches, column-parallel wide layers;
                         2. the SUN-D (DeepEMD) task batch with its episodes
                            sharded over ``data``;
                         3. the episodic eval with episodes sharded over
                            ``data`` (``eval.run --mesh-data``);
                         4. the pretrain step on ``dp x tp``;
                         5. the meta-tune step with episodes sharded.

``dryrun_multichip`` spawns its ``n`` ranks itself (a free port and a
wall-clock limit for the group) unless the caller is already a rank of a
group of ``n``, where it runs the patterns in place. With ``device="cuda"``
on a machine with fewer cards than ranks, the ranks share the cards over
gloo; it never falls back to CPU ranks by itself.

Run:  python -m fewshot_vit_tpu_torch.graft_entry [--n 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from typing import Any

import numpy as np
import torch
from torch import nn

from .core.device import resolve_device
from .core.registry import models
from .heads import meta_baseline as _heads  # noqa: F401  (registers the heads)

DRYRUN_TIMEOUT_S = 600.0
# the tiny-but-real encoder of every pattern: full Visformer topology
TINY_VISFORMER = dict(img_size=32, init_channels=16, embed_dim=64, depth=(1, 1, 1),
                      num_heads=4, attn_stage="011", spatial_conv="100")


def entry(device: Any = "cuda"):
    """``(fn, (module, x_shot, x_query))``: ``fn(module, x_shot, x_query)``
    is the eval-mode forward of the flagship head (seeded weights); the
    inputs are zeros of JAX's shapes, (1, 5, 1, 80, 80, 3) and
    (1, 75, 80, 80, 3), in the port's NHWC layout."""
    dev = resolve_device(device)
    head = models.make("meta-baseline", encoder="visformer_micro_80", device=dev, seed=0)
    x_shot = torch.zeros((1, 5, 1, 80, 80, 3), dtype=torch.float32, device=dev)
    x_query = torch.zeros((1, 75, 80, 80, 3), dtype=torch.float32, device=dev)

    def fn(module, x_shot, x_query):
        with torch.no_grad():
            return module.eval()(x_shot, x_query)

    return fn, (head, x_shot, x_query)


def dryrun_multichip(n_devices: int, device: Any = "cuda",
                     timeout_s: float = DRYRUN_TIMEOUT_S) -> None:
    """One step of each of the five patterns over ``n_devices`` ranks;
    rank 0 prints one ``dryrun_multichip ok`` line per pattern. Inside a
    process group of ``n_devices`` it runs in place, else it starts the
    ranks and relays rank 0's output; a rank that fails, or a group that
    outlives ``timeout_s``, raises."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() == n_devices:
        _dryrun_impl(n_devices, device)
        return
    _spawn_dryrun(n_devices, str(device), timeout_s)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_dryrun(n: int, device: str, timeout_s: float) -> None:
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                                              if p))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fewshot_vit_tpu_torch.graft_entry", "--rank-of", str(n),
             "--device", device], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"dryrun_multichip: the {n} ranks outlived {timeout_s:.0f} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if outs[0][0]:
        print(outs[0][0], end="", flush=True)
    bad = [(r, p.returncode, err) for r, (p, (_, err)) in enumerate(zip(procs, outs))
           if p.returncode]
    if bad:
        raise RuntimeError("dryrun_multichip: " + "\n".join(
            f"rank {r} exited {rc}:\n{err[-3000:]}" for r, rc, err in bad))


def _tiny_visformer(dev, seed: int = 0):
    from .models.visformer import Visformer

    return Visformer(**TINY_VISFORMER, device=dev, seed=seed)


def _tp_of(n: int) -> int:
    return 2 if n % 2 == 0 else 1


def _qkv_sharding(module: nn.Module, tp: int) -> str:
    """The stage-2 ``qkv`` weight's layout after the update: its rows (the
    output features) on ``model`` when tp > 1 (asserted), else whole."""
    qkv = module.encoder.stage2[0].attn.qkv
    spec = getattr(qkv.weight, "tp", None)
    if tp > 1:
        assert spec is not None and qkv.weight.shape[0] * tp == spec.full_out, (
            f"qkv lost its model sharding: {tuple(qkv.weight.shape)}")
        return f"('model', None) rows {spec.index * qkv.weight.shape[0]}:" \
               f"{(spec.index + 1) * qkv.weight.shape[0]} of {spec.full_out}"
    return "(None, None)"


def _print0(mesh, line: str) -> None:
    if mesh.rank == 0:
        print(line, flush=True)


def _dryrun_impl(n: int, device: Any) -> None:
    """The five patterns in this rank (every rank of the group calls it)."""
    _dryrun_sun_dp_tp(n, device)
    _dryrun_emd_episode_parallel(n, device)
    _dryrun_eval_episode_parallel(n, device)
    _dryrun_pretrain_dp_tp(n, device)
    _dryrun_meta_tune_episode_parallel(n, device)


def _dryrun_sun_dp_tp(n: int, device: Any) -> None:
    """Pattern 1: a full SUN step (frozen teacher forward, student forward
    and backward, AdamW, global BN statistics) on ``{data: n/tp, model:
    tp}``, the batch sharded over ``data``, the wide layers column-parallel."""
    from .heads.token_label import TokenLabel
    from .parallel.mesh import make_mesh, param_shardings, use_mesh
    from .train.loop import make_sun_epoch
    from .train.optim import make_optimizer
    from .train.state import TrainState

    tp = _tp_of(n)
    mesh = make_mesh({"data": n // tp, "model": tp}, device)
    dev = mesh.device
    n_classes = 8
    student = TokenLabel(_tiny_visformer(dev, 0), n_classes, seed=0).to(dev)
    teacher = TokenLabel(_tiny_visformer(dev, 1), n_classes, seed=1).to(dev)
    teacher.requires_grad_(False).eval()
    rng = np.random.default_rng(0)
    batch = mesh.size("data") * 2
    images = torch.from_numpy(rng.integers(0, 255, (batch, 32, 32, 3)).astype(np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, n_classes, (batch,)).astype(np.int64)).to(dev)
    param_shardings(mesh, student, min_features=64)  # before the optimizer sees the slices
    state = TrainState(student, make_optimizer(student.parameters(), "adamw", lr=1e-3,
                                               weight_decay=0.05))
    # the tiny encoder's dense map is 2x2 = 4 tokens: 1 background token
    epoch = make_sun_epoch(None, soft_k=3, bg_tokens=1, token_weight=0.5)
    idx = torch.arange(batch, device=dev)[None]
    with use_mesh(mesh):
        ms = epoch(state, teacher, images, labels, idx, (0, 2))
    loss = float(ms["loss"][0])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    _print0(mesh, f"dryrun_multichip ok: mesh={mesh.shape} loss={loss:.4f} step={state.step} "
                  f"qkv_sharding={_qkv_sharding(student, tp)}")


class _TinyEnc(nn.Module):
    """Two stride-2 3x3 convs (NHWC): (dense map, pooled)."""

    def __init__(self, dev, seed: int = 0):
        super().__init__()
        from .models.common import Conv, init_weights

        self.conv1 = Conv(3, 8, 3, stride=2, padding=1, bias=True)
        self.conv2 = Conv(8, 8, 3, stride=2, padding=1, bias=True)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    def forward(self, x):
        x = torch.relu(self.conv2(self.conv1(x)))
        return x, x.mean(dim=(1, 2))


def _dryrun_emd_episode_parallel(n: int, device: Any) -> None:
    """Pattern 2: SUN-D (DeepEMD) meta-tuning with the task batch's episodes
    sharded over a pure-data mesh (``train/meta_tune_emd.py`` under
    ``mesh:``): one forward, backward and update (fcn nodes, Sinkhorn, the
    encoder rematerialized), episode gradients all-reduced."""
    from .heads.deepemd import DeepEMD
    from .parallel.mesh import make_mesh
    from .train.meta_tune_emd import make_emd_episode_fn, make_emd_epoch_fn, make_patch_fn
    from .train.optim import ScheduledOptimizer
    from .train.state import TrainState

    mesh = make_mesh({"data": n}, device)
    dev = mesh.device
    way, shot, query, epb = 2, 1, 2, n
    head = DeepEMD(_TinyEnc(dev), solver_iters=5).to(dev)
    patch_fn = make_patch_fn("fcn", [2], 2.0, 16, train=True, num_patch=4)
    episode_fn = make_emd_episode_fn(head, way, shot, query, patch_fn, (0.5,) * 3, (0.5,) * 3,
                                     sfc=False, train=True, remat=True)
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, (24, 16, 16, 3)).astype(np.uint8)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 24, (1, epb, way * (shot + query)))
                           .astype(np.int64)).to(dev)
    state = TrainState(head, ScheduledOptimizer(
        torch.optim.SGD(head.parameters(), lr=1e-2, momentum=0.9)))
    labels = torch.arange(way, device=dev).repeat(query)
    ms = make_emd_epoch_fn(episode_fn, labels, epb, mesh=mesh)(state, images, idx, (0, 3))
    loss = float(ms["loss"][0])
    assert np.isfinite(loss), f"non-finite SUN-D loss {loss}"
    _print0(mesh, f"dryrun_multichip ok (emd episode-parallel): mesh={mesh.shape} "
                  f"episodes/step={epb} sharded over data, loss={loss:.4f}")


def _dryrun_eval_episode_parallel(n: int, device: Any) -> None:
    """Pattern 3: the north-star program, episodic eval with the episode
    batch sharded over a pure-data mesh (``eval.run --mesh-data N``): data
    and weights whole on every rank, full re-encode per episode."""
    from .data.datasets import synthetic
    from .eval.episodic import evaluate
    from .heads.meta_baseline import MetaBaseline
    from .parallel.mesh import make_mesh

    mesh = make_mesh({"data": n}, device)
    ds = synthetic(n_classes=6, n_per_class=8, image_size=32, seed=0)
    head = MetaBaseline(_tiny_visformer(mesh.device)).to(mesh.device).eval()
    acc, ci, accs = evaluate(head, ds, n_episodes=2 * n, way=5, shot=1, query=3,
                             ep_per_batch=2 * n, seed=3, device=mesh.device, mesh=mesh)
    assert np.isfinite(acc) and len(accs) == 2 * n
    _print0(mesh, f"dryrun_multichip ok (episodic eval --mesh-data): mesh={mesh.shape} "
                  f"episodes sharded over data, acc={acc:.4f}+-{ci:.4f}")


def _dryrun_pretrain_dp_tp(n: int, device: Any) -> None:
    """Pattern 4: the phase-1 pretrain step (CE, AdamW, global BN
    statistics) on ``dp x tp`` with column-parallel wide layers."""
    from .heads.classifier import Classifier, LinearClassifier
    from .parallel.mesh import make_mesh, param_shardings, use_mesh
    from .train.loop import make_pretrain_epoch
    from .train.optim import make_optimizer
    from .train.state import TrainState

    tp = _tp_of(n)
    mesh = make_mesh({"data": n // tp, "model": tp}, device)
    dev = mesh.device
    enc = _tiny_visformer(dev)
    model = Classifier(enc, LinearClassifier(enc.out_dim, 6,
                                             generator=torch.Generator().manual_seed(1))).to(dev)
    rng = np.random.default_rng(2)
    batch = mesh.size("data") * 2
    images = torch.from_numpy(rng.integers(0, 255, (batch, 32, 32, 3)).astype(np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 6, (batch,)).astype(np.int64)).to(dev)
    param_shardings(mesh, model, min_features=64)
    state = TrainState(model, make_optimizer(model.parameters(), "adamw", lr=1e-3,
                                             weight_decay=0.05))
    with use_mesh(mesh):
        ms = make_pretrain_epoch()(state, images, labels, torch.arange(batch, device=dev)[None],
                                   (0, 1))
    loss = float(ms["loss"][0])
    assert np.isfinite(loss), f"non-finite pretrain loss {loss}"
    _print0(mesh, f"dryrun_multichip ok (phase-1 pretrain dp x tp): mesh={mesh.shape} "
                  f"loss={loss:.4f} qkv_sharding={_qkv_sharding(model, tp)}")


def _dryrun_meta_tune_episode_parallel(n: int, device: Any) -> None:
    """Pattern 5: the phase-3a SUN-M meta-tune step (episodic CE,
    MetaBaseline, ``freeze_bn``) with the task batch's episodes sharded over
    a pure-data mesh (``train/meta_tune.py`` under ``mesh:``)."""
    from .heads.meta_baseline import MetaBaseline
    from .parallel.mesh import make_mesh, use_mesh
    from .train.loop import make_meta_tune_epoch
    from .train.optim import make_optimizer
    from .train.state import TrainState

    mesh = make_mesh({"data": n}, device)
    dev = mesh.device
    head = MetaBaseline(_tiny_visformer(dev)).to(dev)
    way, shot, query, epb = 3, 1, 2, n
    n_img = epb * way * (shot + query)
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 255, (n_img, 32, 32, 3)).astype(np.uint8)).to(dev)
    state = TrainState(head, make_optimizer(head.parameters(), "sgd", lr=1e-3))  # momentum 0.9
    epoch = make_meta_tune_epoch(way, shot, query, epb, freeze_bn=True)
    with use_mesh(mesh):
        ms = epoch(state, images, torch.arange(n_img, device=dev)[None], (0, 1))
    loss = float(ms["loss"][0])
    assert np.isfinite(loss) and state.step == 1, (loss, state.step)
    _print0(mesh, f"dryrun_multichip ok (phase-3a meta-tune episode-parallel): "
                  f"mesh={mesh.shape} episodes/step={epb} sharded over data, "
                  f"loss={loss:.4f} freeze_bn=True")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=8, help="ranks of the dryrun (default 8)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--rank-of", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank_of is not None:  # one rank of a spawned group
        import torch.distributed as dist

        torch.set_num_threads(1)
        _dryrun_impl(args.rank_of, args.device)
        dist.barrier()
        dist.destroy_process_group()
        return 0
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
