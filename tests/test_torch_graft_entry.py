"""Port parity, the entry points of ``__graft_entry__.py``: ``fewshot_vit_tpu_torch/graft_entry.py``
against the repository's ``__graft_entry__.py``: ``entry()``'s forward on
the carried weights, ``dryrun_multichip(2)`` over two gloo CPU ranks, and
the in-process branch inside a group of ``n``. The patterns' parity with
JAX is held by ``tests/test_torch_mesh*.py``; here they run end to end."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as jentry
from fewshot_vit_tpu_torch import graft_entry
from fewshot_vit_tpu_torch.checkpoint import load_flax

from .torch_port_helpers import free_port, numpy_tree

torch.set_num_threads(1)
# the flagship forward in fp32: 80 images through the full-width encoder,
# the logits' scale 10; summation order alone (XLA:CPU against ATen)
# measured 6.8e-7 of max-abs on the seeded inputs (0 on the zeros, where every
# logit is the temperature, 10)
FORWARD_TOL = 1e-5
DRYRUN_LIMIT_S = 60


def test_entry_forward_matches_jax():
    """JAX's ``entry()`` and the port's, the port's module carrying JAX's
    initialized variables: the logits on the entry's zero inputs and on
    seeded inputs of the same shapes within 1e-5 of their max-abs."""
    jfn, (variables, xs, xq) = jentry.entry()
    fn, (module, t_xs, t_xq) = graft_entry.entry(device="cpu")
    assert tuple(t_xs.shape) == tuple(xs.shape) and tuple(t_xq.shape) == tuple(xq.shape)
    assert t_xs.dtype == torch.float32 and not t_xs.any() and not t_xq.any()
    module = load_flax(module, numpy_tree(variables))
    rng = np.random.default_rng(0)
    seeded = (rng.normal(size=xs.shape).astype(np.float32),
              rng.normal(size=xq.shape).astype(np.float32))
    jit_fn = jax.jit(jfn)
    for a, b in ((np.array(xs), np.array(xq)), seeded):
        want = np.asarray(jit_fn(variables, a, b))
        got = fn(module, torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert got.shape == want.shape == (1, 75, 5)
        assert np.abs(got - want).max() <= FORWARD_TOL * np.abs(want).max()


def test_dryrun_two_cpu_ranks_prints_five_ok_lines(capsys):
    graft_entry.dryrun_multichip(2, device="cpu", timeout_s=DRYRUN_LIMIT_S)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip ok")]
    assert len(lines) == 5, lines
    assert "mesh={'data': 1, 'model': 2}" in lines[0] and "('model', None)" in lines[0]
    assert "emd episode-parallel" in lines[1] and "--mesh-data" in lines[2]
    assert "pretrain dp x tp" in lines[3] and "('model', None)" in lines[3]
    assert "meta-tune episode-parallel" in lines[4]


def test_in_process_branch_inside_a_group_of_n(monkeypatch):
    """Inside a process group of ``n`` the patterns run in place (stubbed
    here); in a group of another size, or none, the ranks are spawned."""
    calls = []
    monkeypatch.setattr(graft_entry, "_dryrun_impl", lambda n, device: calls.append(("in", n)))
    monkeypatch.setattr(graft_entry, "_spawn_dryrun",
                        lambda n, device, timeout_s: calls.append(("spawn", n)))
    graft_entry.dryrun_multichip(1, device="cpu")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        graft_entry.dryrun_multichip(1, device="cpu")
        graft_entry.dryrun_multichip(2, device="cpu")
    finally:
        dist.destroy_process_group()
    assert calls == [("spawn", 1), ("in", 1), ("spawn", 2)]


def test_a_failing_rank_raises(monkeypatch):
    with pytest.raises(RuntimeError, match="rank 0 exited"):
        graft_entry.dryrun_multichip(1, device="no-such-device", timeout_s=DRYRUN_LIMIT_S)
