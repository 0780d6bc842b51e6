"""Shared pieces of the ``test_torch_*`` parity tests: a narrow Visformer
geometry that still reaches the attention dispatch (img 80 -> stage 2 has
T = 10x10 = 100 tokens), numpy copies of flax trees, non-trivial BN stats,
the skip for tests that need the card, and the rank processes of the mesh
tests (``python -m tests.torch_port_helpers JOB DIR``)."""

import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

# narrow widths, full img 80: stage-2 T=100 (hd 16), stage-3 T=25 (hd 32)
SMALL_VISFORMER = dict(img_size=80, init_channels=16, embed_dim=96,
                       depth=(1, 1, 1), num_heads=6)


def numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


def randomize_bn(variables, seed=3):
    """Give every BN non-trivial running stats and affine params (fresh
    stats of mean 0 / var 1 would hide sign and offset faults in a fold)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, dict):
                out[k] = walk(v, p)
                continue
            is_bn = any(s == "bn" or s.startswith("bn") or s.endswith("_bn") for s in p[:-1])
            if k == "mean":
                v = rng.normal(0.0, 0.5, v.shape)
            elif k == "var":
                v = rng.uniform(0.25, 4.0, v.shape)
            elif is_bn and k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif is_bn and k == "bias":
                v = rng.normal(0.0, 0.3, v.shape)
            out[k] = np.asarray(v, np.float32)
        return out

    return {col: walk(tree, ()) for col, tree in variables.items()}


def strided_layer_inputs(module, run):
    """``run()`` -> (its result, the names of the ``Conv`` / ``Linear``
    layers inside ``module`` whose input was not NHWC-contiguous)."""
    from fewshot_vit_tpu_torch.models.common import Conv, Linear

    strided = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args, name=name: None if args[0].is_contiguous() else strided.append(name))
        for name, m in module.named_modules() if isinstance(m, (Conv, Linear))]
    try:
        return run(), strided
    finally:
        for h in hooks:
            h.remove()


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run python3 chip_smoke.py or pytest -m cuda on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


# --- process groups on the CPU ---------------------------------------------------------
# A test starts its ranks as ``python -m tests.torch_port_helpers JOB DIR``
# processes with torchrun's environment (``launch_ranks``): each rank reads
# its inputs from DIR, runs JOB over gloo and writes ``JOB.out<rank>.pt``
# there. Every group has a free port of its own (bound to port 0 first) and
# its own time limit, after which its processes are killed and the test fails.
REPO = pathlib.Path(__file__).resolve().parent.parent
GROUP_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(job: str, workdir, world: int, env_vars: bool = True):
    """Start ``world`` rank processes of ``job`` (not waited for)."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MESH_TEST_RANK=str(rank),
                   MESH_TEST_PORT=str(port), MESH_TEST_WORLD=str(world))
        if env_vars:  # torchrun's variables
            env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_port_helpers", job, str(workdir)],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def wait_ranks(procs, timeout: float = GROUP_TIMEOUT_S):
    """Wait for a group; returns each rank's stdout. A rank that fails or
    outlives ``timeout`` fails the test, and every rank is killed."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append((out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"a rank group outlived its {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(i, p.returncode, e) for i, (p, (_, e)) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise AssertionError("\n".join(f"rank {i} exited {rc}:\n{e[-4000:]}" for i, rc, e in bad))
    return [o for o, _ in outs]


# --- what the ranks run ------------------------------------------------------------------
def rank_mesh(axes):
    from fewshot_vit_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axes, "cpu")


class NanToy(torch.nn.Module):
    """One scalar weight (and an unused one) for the task batch's NaN rule."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(1.0))
        self.unused = torch.nn.Parameter(torch.tensor(2.0))


def _build(case):
    """The case's port module(s), loaded from its state dict(s)."""
    from fewshot_vit_tpu_torch.heads.classifier import make_classifier
    from fewshot_vit_tpu_torch.heads.deepemd import DeepEMD
    from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline
    from fewshot_vit_tpu_torch.heads.token_label import TokenLabel
    from fewshot_vit_tpu_torch.models.visformer import Visformer

    kind, enc = case["kind"], case.get("encoder")
    if kind == "pretrain":
        m = make_classifier("visformer_micro_80", encoder_args=enc,
                            classifier_args={"n_classes": case["n_classes"]}, device="cpu")
    elif kind == "sun":
        m = TokenLabel(Visformer(**enc, device="cpu"), case["n_classes"])
    elif kind == "meta_tune":
        m = MetaBaseline(Visformer(**enc, device="cpu"))
    elif kind == "sund":
        m = DeepEMD(Visformer(**enc, device="cpu"), solver_iters=20)
    else:
        return NanToy()
    m.load_state_dict(case["state"])
    return m


def run_step_case(case, mesh=None, keep_state=False):
    """One epoch of a trainer's steps as ``case`` (built by the mesh tests)
    describes it, under ``mesh`` or on one process -> the state's variables
    (full layout) and the per-step metrics (and the state itself with
    ``keep_state``)."""
    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.data.augment import make_cropaug_fn, make_dual_view_fn
    from fewshot_vit_tpu_torch.parallel.mesh import param_shardings, use_mesh
    from fewshot_vit_tpu_torch.train import loop
    from fewshot_vit_tpu_torch.train import meta_tune_emd as tt
    from fewshot_vit_tpu_torch.train.optim import ScheduledOptimizer, make_optimizer
    from fewshot_vit_tpu_torch.train.state import TrainState

    kind, mean, std = case["kind"], case.get("mean"), case.get("std")
    module = _build(case)
    if mesh is not None and case.get("min_features"):
        param_shardings(mesh, module, case["min_features"])
    images = torch.from_numpy(case["images"])
    idx = torch.from_numpy(case["idx"].astype(np.int64))
    key = tuple(case["key"])
    if kind in ("sund", "nan"):
        if kind == "nan":
            opt = ScheduledOptimizer(torch.optim.SGD(module.parameters(), lr=case["lr"]),
                                     zero_nan=True)
            base = torch.from_numpy(case["base"])

            def episode_fn(imgs, episode_ids, key=None):
                bad = torch.where(imgs[0, 0, 0, 0, 0].float() == 255.0, float("nan"), 1.0)
                return (module.w * bad * base)[None]
        else:
            opt = tt.build_sund_optimizer(Config(case["cfg"]), module.parameters())
            episode_fn = tt.make_emd_episode_fn(
                module, case["way"], 1, case["query"],
                tt.make_patch_fn("fcn", [2, 3], 2.0, images.shape[1], True), mean, std,
                sfc=False, train=True)
        state = TrainState(module, opt)
        labels = torch.arange(case["way"]).repeat(case["query"])
        ms = tt.make_emd_epoch_fn(episode_fn, labels, case["epb"], mesh=mesh)(
            state, images, idx, key)
        return {"variables": state.variables, "ms": ms}
    state = TrainState(module, make_optimizer(module.parameters(), case.get("opt", "sgd"),
                                              lr=case["lr"], weight_decay=case["wd"]))
    labels = torch.from_numpy(case["labels"].astype(np.int64)) if "labels" in case else None
    size = images.shape[1]
    with use_mesh(mesh):
        if kind == "pretrain":
            pre = make_cropaug_fn(mean, std, out_size=size) if case.get("augment") else None
            ms = loop.make_pretrain_epoch(pre, mean, std)(state, images, labels, idx, key)
        elif kind == "sun":
            teacher = _build({**case, "state": case["teacher"]}).requires_grad_(False)
            dual = make_dual_view_fn(mean, std, out_size=size) if case.get("augment") else None
            ms = loop.make_sun_epoch(dual, mean, std, **case["sun_kw"])(
                state, teacher, images, labels, idx, key)
        else:
            ms = loop.make_meta_tune_epoch(case["way"], 1, case["query"], case["epb"],
                                           mean=mean, std=std)(state, images, idx, key)
    return {"variables": state.variables, "ms": ms, **({"state": state} if keep_state else {})}


def _job_steps(workdir):
    mesh = rank_mesh({"data": 2})
    cases = torch.load(workdir / "steps.pt", weights_only=False)
    return {name: run_step_case(case, mesh) for name, case in cases.items()}


def _job_tp(workdir):
    """The ``{data: 2, model: 2}`` step, the slices, and a resume: the
    full-layout train state loaded into a fresh sharded model and optimizer
    gives back every slice and momentum buffer."""
    from fewshot_vit_tpu_torch.parallel.mesh import param_shardings
    from fewshot_vit_tpu_torch.train.optim import make_optimizer
    from fewshot_vit_tpu_torch.train.state import TrainState

    case = torch.load(workdir / "tp.pt", weights_only=False)["tp"]
    mesh = rank_mesh({"data": 2, "model": 2})
    probe = _build(case)
    sliced = param_shardings(mesh, probe, case["min_features"])
    local = {k: v.clone() for k, v in probe.state_dict().items()}
    out = run_step_case(case, mesh, keep_state=True)
    state = out.pop("state")
    saved = state.state_dict()
    fresh = TrainState(probe, make_optimizer(probe.parameters(), "sgd", lr=case["lr"],
                                             weight_decay=case["wd"]))
    fresh.load_state_dict(saved)
    bufs = lambda s: [s.optimizer.optimizer.state[p]["momentum_buffer"]
                      for p in s.module.parameters()]
    resumed = (all(torch.equal(a, b) for a, b in zip(state.module.state_dict().values(),
                                                     fresh.module.state_dict().values()))
               and all(torch.equal(a, b) for a, b in zip(bufs(state), bufs(fresh))))
    names = [n for n, _ in state.module.named_parameters()]
    full_bufs = {names[i]: v["momentum_buffer"].shape
                 for i, v in saved["optimizer"]["state"].items()}
    return {"tp": out, "sliced": sliced, "local": local, "resumed": resumed,
            "saved_buf_shapes": full_bufs}


def _job_tcp(workdir):
    from fewshot_vit_tpu_torch.parallel.mesh import init_distributed, make_mesh

    rank, port = int(os.environ["MESH_TEST_RANK"]), int(os.environ["MESH_TEST_PORT"])
    n = init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                         process_id=rank, device="cpu")
    mesh = make_mesh({"data": 2}, "cpu")
    got = mesh.gather(torch.tensor([float(rank)]))
    return {"world": n, "again": init_distributed(), "gather": got, "backend": mesh.backend}


def bn_over(mesh, state, x, g):
    """A training-mode ``models.common.BatchNorm`` over this rank's block of
    ``x`` (the whole of it without ``mesh``), with the loss sum(y * g) ->
    its output, input gradient, parameter gradients and running statistics."""
    from fewshot_vit_tpu_torch.models.common import BatchNorm
    from fewshot_vit_tpu_torch.parallel.mesh import use_mesh

    bn = BatchNorm(x.shape[-1])
    bn.load_state_dict(state)
    bn.train()
    if mesh is not None:
        x, g = mesh.shard(x), mesh.shard(g)
    x = x.clone().requires_grad_(True)
    with use_mesh(mesh):
        y = bn(x)
        (y * g).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.bn.weight.grad, "db": bn.bn.bias.grad,
            "mean": bn.bn.running_mean, "var": bn.bn.running_var}


def _job_lib(workdir):
    """Global BN, ``evaluate(mesh=)`` and the sharded artifacts served."""
    from fewshot_vit_tpu_torch.data.datasets import synthetic
    from fewshot_vit_tpu_torch.eval.episodic import evaluate
    from fewshot_vit_tpu_torch.eval.export import load_exported, serve
    from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline
    from fewshot_vit_tpu_torch.models.visformer import Visformer

    mesh = rank_mesh({"data": 2})
    inp = torch.load(workdir / "lib.pt", weights_only=False)
    out = {"bn": bn_over(mesh, inp["bn_state"], inp["bn_x"], inp["bn_g"])}
    head = MetaBaseline(Visformer(**inp["encoder"], device="cpu"))
    head.load_state_dict(inp["head"])
    ds = synthetic(**inp["data"])
    out["evaluate"] = evaluate(head.eval(), ds, indices=inp["indices"], n_episodes=inp["n_ep"],
                               way=inp["way"], shot=1, query=inp["query"],
                               ep_per_batch=inp["epb"], device="cpu", mesh=mesh)[2]
    out["serve"] = {}
    for name, inputs in inp["artifacts"].items():
        ep = load_exported(str(workdir / f"{name}.pt2"), device="cpu", mesh=mesh)
        with torch.no_grad():
            out["serve"][name] = serve(ep, *inputs, mesh=mesh)
    return out


def _job_eval_clis(workdir):
    """The eval CLIs of ``eval_clis.pt`` in turn, each with ``--mesh-data``."""
    from fewshot_vit_tpu_torch.eval import run, run_emd

    mods = {"run": run, "run_emd": run_emd}
    return {name: mods[mod].main(argv)
            for name, (mod, argv) in torch.load(workdir / "eval_clis.pt").items()}


def _job_train_clis(workdir):
    """The trainer CLIs of ``clis.pt`` in turn; rank 0 prints ``=== <name>``
    before each."""
    from fewshot_vit_tpu_torch.train import meta_tune, meta_tune_emd, pretrain, runner, sun

    mods = {"pretrain": pretrain, "sun": sun, "meta_tune": meta_tune,
            "meta_tune_emd": meta_tune_emd}
    steps = {}
    for name, argv in torch.load(workdir / "clis.pt", weights_only=False):
        if os.environ["MESH_TEST_RANK"] == "0":
            print(f"=== {name}", flush=True)
        steps[name] = mods[name].main(*runner.parse_args("t", argv)).step
    return steps


JOBS = {"steps": _job_steps, "tp": _job_tp, "tcp": _job_tcp, "train_clis": _job_train_clis,
        "lib": _job_lib, "eval_clis": _job_eval_clis}


def rank_outputs(job: str, workdir, world: int):
    """Every rank's result of ``job``."""
    return [torch.load(pathlib.Path(workdir) / f"{job}.out{r}.pt", weights_only=False)
            for r in range(world)]


def main(job: str, workdir: str) -> None:
    torch.set_num_threads(1)
    workdir = pathlib.Path(workdir)
    out = JOBS[job](workdir)
    torch.save(out, workdir / f"{job}.out{os.environ['MESH_TEST_RANK']}.pt")


if __name__ == "__main__":
    main(*sys.argv[1:3])
