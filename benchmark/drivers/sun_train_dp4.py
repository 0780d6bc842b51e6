"""Traffic ``sun_train_dp4``: ``sun_train``'s SUN steps, data-parallel over
the traffic's ``mesh`` (``{"data": 4}``): one process a device, the global
batch augmented alike on every rank and each rank's block of it through the
student and the teacher, global-batch BN statistics, the gradients averaged
over the ranks before AdamW (``parallel.mesh``; NCCL on the cards, gloo on
the CPU).

The harness's process is rank 0, on device 0. Its ``Cell`` starts ranks
1 .. N-1 itself, each a ``python -m benchmark.drivers.sun_train_dp4``
process on device r that builds the same state from the seed, and drives
them in lockstep: before each of its own ``warm``, ``prime``, ``call`` and
``sub_call`` it sends the command to every rank (a broadcast on a gloo
group), and every rank runs it under the mesh. ``free`` sends ``free`` and
joins them. A rank that has ended is seen at rank 0's next command and ends
the run with an error; a collective that waits on a lost rank ends at the
group's timeout.

The checked steps are ``sun_train``'s. Each rank keeps its block of the
teacher's patch logits and of the soft labels, and ``prime`` gathers them
to every rank; the views are the global batch's on every rank, and the
losses, the first gradient and the parameter change are the global step's.
So the check is ``sun_train``'s against the single-process reference at the
global batch. ``units_per_call`` counts the global batch; ``peak_flops`` is
the N devices' peak.

Each rank takes an N-th of the host's cores for its intra-op threads
(``torch.set_num_threads``, and ``OMP_NUM_THREADS`` in the ranks it starts),
so that the N processes do not contend for every core.

The fault ``no_grad_sync`` leaves out the gradient all-reduce
(``train.grad_sync``) on every rank: each rank then steps on its own block's
gradients, as a data-parallel program that forgot to average them would."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from . import sun_train

ROOT = Path(__file__).resolve().parents[2]
COMMANDS = ("warm", "prime", "call", "sub_call", "free")
TIMEOUT = timedelta(seconds=180)  # a collective waiting on a lost rank ends here
JOIN_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Cell(sun_train.Cell):
    def __init__(self, spec: dict, device, seed: int, control: bool = False,
                 fault: Optional[str] = None, rank: int = 0, port: Optional[int] = None):
        from fewshot_vit_tpu_torch.parallel.mesh import make_mesh, use_mesh

        self.rank, self.world = rank, int(spec["traffic"]["mesh"]["data"])
        self.workers, self._nested, self._synced = [], 0, None
        device = torch.device(device)
        threads = max(1, len(os.sched_getaffinity(0)) // self.world)
        torch.set_num_threads(threads)
        if rank == 0:
            port = free_port()
            kw = json.dumps({"control": control, "fault": fault})
            env = {**os.environ, "OMP_NUM_THREADS": str(threads)}
            for r in range(1, self.world):
                p = subprocess.Popen([sys.executable, "-m", "benchmark.drivers.sun_train_dp4",
                                      str(seed), str(r), str(port), device.type, kw],
                                     cwd=ROOT, env=env, stdin=subprocess.PIPE, stdout=2,
                                     text=True)
                p.stdin.write(json.dumps(spec))
                p.stdin.close()
                self.workers.append(p)
        if device.type == "cuda":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", world_size=self.world,
                                rank=rank, timeout=TIMEOUT)
        self.commands = dist.new_group(backend="gloo", timeout=TIMEOUT)
        self.mesh = make_mesh({"data": self.world}, device)
        self.use_mesh = use_mesh
        super().__init__(spec, device, seed, control, fault)
        self.peak_flops *= self.world
        if fault == "no_grad_sync":
            from fewshot_vit_tpu_torch.train import steps

            self._synced = steps.sync_tensors
            steps.sync_tensors = lambda tensors: None

    # --- lockstep ---------------------------------------------------------------
    def _send(self, name: str) -> None:
        ended = [(r, p.returncode) for r, p in enumerate(self.workers, 1) if p.poll() is not None]
        if ended:
            raise RuntimeError(f"rank(s) ended before {name!r}: (rank, exit code) {ended}")
        dist.broadcast(torch.tensor([COMMANDS.index(name)]), 0, group=self.commands)

    def receive(self) -> str:
        code = torch.zeros(1, dtype=torch.long)
        dist.broadcast(code, 0, group=self.commands)
        return COMMANDS[int(code)]

    def _run(self, name: str) -> None:
        """Rank 0 sends ``name`` to every rank unless it runs inside another
        command (``warm`` holds ``prime``); every rank runs it under the mesh."""
        if self.rank == 0 and not self._nested:
            self._send(name)
        self._nested += 1
        try:
            with self.use_mesh(self.mesh):
                getattr(sun_train.Cell, name)(self)
        finally:
            self._nested -= 1

    def warm(self) -> None:
        self._run("warm")

    def prime(self) -> None:
        """``sun_train``'s checked steps, then every rank's blocks of the
        teacher's logits and of the soft labels gathered to every rank."""
        self._run("prime")
        self.teacher_out = [self.mesh.gather(t) for t in self.teacher_out]
        self.soft_out = [self.mesh.gather(s) for s in self.soft_out]

    def call(self) -> None:
        self._run("call")

    def sub_call(self) -> None:
        self._run("sub_call")

    def free(self) -> None:
        if self.rank == 0:
            self._send("free")
        if self._synced is not None:
            from fewshot_vit_tpu_torch.train import steps

            steps.sync_tensors = self._synced
        super().free()
        dist.destroy_process_group()
        failed = []
        for r, p in enumerate(self.workers, 1):
            try:
                rc = p.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = "killed"
            if rc != 0:
                failed.append((r, rc))
        if failed:
            raise RuntimeError(f"rank(s) failed: (rank, exit code) {failed}")


def worker(argv) -> int:
    """Rank r: the same cell from the same spec and seed, driven by rank 0's
    commands until ``free``."""
    seed, rank, port, device, kw = argv
    spec = json.loads(sys.stdin.read())
    cell = Cell(spec, torch.device(device), int(seed), rank=int(rank), port=int(port),
                **json.loads(kw))
    while True:
        name = cell.receive()
        if name == "free":
            break
        getattr(cell, name)()
    cell.free()
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1:]))
