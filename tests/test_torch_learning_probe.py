"""Port parity, the learning gate: ``fewshot_vit_tpu_torch/tools/
learning_probe.py`` against the repository's ``tools/learning_probe.py``.

JAX's probe is read with ``ast``, never run: its epoch programs take minutes
to compile on the CPU. The four phase configs, the data, the seeds and the
SFC settings are held to its literals key for key; then one 1-epoch run of
every phase at a tiny size on the CPU prints the six keys. The gate's
numbers come from the card (``chip_smoke.py`` phase 34)."""

import ast
import json
import os
import pathlib

import pytest
import torch

from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.models.visformer import Visformer
from fewshot_vit_tpu_torch.tools import learning_probe as lp

from .torch_port_helpers import SMALL_VISFORMER

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PROBE = ROOT / "tools" / "learning_probe.py"
KEYS = ["p0", "p1", "p2", "p3", "p4_1shot", "p4_5shot"]


def _literal(node, ns):
    return eval(compile(ast.Expression(node), str(JAX_PROBE), "eval"), ns)


@pytest.fixture(scope="module")
def jax_probe():
    """JAX's literals: the four ``Config({...})`` dicts (evaluated with the
    probe's own names bound), ``train_args``, the novel split's arguments,
    the SFC settings, ``run``'s defaults and the env knobs."""
    tree = ast.parse(JAX_PROBE.read_text())
    run_fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run")
    out = {"configs": [], "knobs": {}}
    defaults = run_fn.args.defaults
    names = [a.arg for a in run_fn.args.args][-len(defaults):]
    out["defaults"] = {n: d.value for n, d in zip(names, defaults)}
    for node in ast.walk(run_fn):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "train_args":
            out["train_args"] = _literal(node.value, {})
    ns = {"os": os, "save_root": "/save", "enc_name": "visformer_micro_80",
          "train_args": out["train_args"], "epochs1": 12, "epochs2": 8, "epochs3": 3,
          "epochs4": 2}
    for node in ast.walk(run_fn):
        if not isinstance(node, ast.Call):
            continue
        fn = getattr(node.func, "id", getattr(node.func, "attr", ""))
        if fn == "Config":
            out["configs"].append((node.lineno, _literal(node.args[0], ns)))
        elif fn == "make" and node.args and getattr(node.args[0], "value", "") == "synthetic-local":
            out["test_args"] = {k.arg: k.value.value for k in node.keywords}
        elif fn == "make_emd_cached_episode_fn":
            out["sfc_kw"] = next(_literal(k.value, {}) for k in node.keywords
                                 if k.arg == "sfc_kw")
    main_fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main_fn):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "get"
                and getattr(getattr(node.func, "value", None), "attr", "") == "environ"
                and len(node.args) == 2):
            out["knobs"][node.args[0].value] = node.args[1].value
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "watchdog_reexec":
            out["watchdog_s"] = node.keywords[0].value.value
    out["configs"] = [c for _, c in sorted(out["configs"], key=lambda t: t[0])]
    return out


def test_phase_configs_equal_jax_key_for_key(jax_probe):
    got = lp.phase_configs("/save", 12, 8, 3, 2)
    assert list(got) == ["p1", "p2", "p3", "p4"]
    assert len(jax_probe["configs"]) == 4
    for (name, cfg), want in zip(got.items(), jax_probe["configs"]):
        assert cfg == want, name
    assert lp.TRAIN_ARGS == jax_probe["train_args"]
    assert lp.TEST_ARGS == jax_probe["test_args"]
    assert lp.SFC_KW == jax_probe["sfc_kw"]


def test_defaults_and_knobs_equal_jax(jax_probe, monkeypatch, capsys, tmp_path):
    import inspect

    params = inspect.signature(lp.run).parameters
    for name, value in jax_probe["defaults"].items():
        assert params[name].default == value, name
    assert params["device"].default == "cuda" and params["n_episodes_5shot"].default is None
    seen = {}
    monkeypatch.setattr(lp, "watchdog_reexec", lambda timeout_s: seen.update(budget=timeout_s))
    monkeypatch.setattr(lp, "run", lambda save_root, **kw: seen.update(kw) or {"p0": 0.2})
    monkeypatch.setenv("LPROBE_SAVE", str(tmp_path))
    monkeypatch.setenv("LPROBE_EPOCHS3", "1")
    lp.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == {"p0": 0.2}
    assert seen.pop("budget") == jax_probe["watchdog_s"]
    want = {"epochs1": 12, "epochs2": 8, "epochs3": 1, "epochs4": 2, "n_episodes": 200,
            "device": "cpu"}
    assert seen == want
    assert {k: v for k, v in jax_probe["knobs"].items()} == {
        "LPROBE_EPOCHS1": 12, "LPROBE_EPOCHS2": 8, "LPROBE_EPOCHS3": 3, "LPROBE_EPOCHS4": 2,
        "LPROBE_EPISODES": 200}


def test_every_phase_runs_one_epoch_on_the_cpu(monkeypatch, tmp_path):
    """Every phase through the port's trainers for one epoch at a tiny size
    (a narrow Visformer, small splits, one step of each trainer, 2 SFC
    steps): the six keys, each an accuracy, and the checkpoints the later
    phases load."""
    monkeypatch.setitem(models._ctors, "visformer_micro_80",
                        lambda **kw: Visformer(**{**SMALL_VISFORMER, **kw}))
    monkeypatch.setattr(lp, "TRAIN_ARGS", {**lp.TRAIN_ARGS, "n_classes": 5, "n_per_class": 16})
    monkeypatch.setattr(lp, "TEST_ARGS", {**lp.TEST_ARGS, "n_classes": 5, "n_per_class": 20})
    monkeypatch.setattr(lp, "SFC_KW", {**lp.SFC_KW, "steps": 2})
    real = lp.phase_configs

    def tiny(*a, **kw):
        cfgs = real(*a, **kw)
        for name in ("p1", "p2"):
            cfgs[name]["batch_size"] = 16
        cfgs["p3"].update(train_batches=1, val_episodes=4)
        cfgs["p4"].update(train_batches=1, val_episode=2)
        return cfgs

    monkeypatch.setattr(lp, "phase_configs", tiny)
    res = lp.run(str(tmp_path), 1, 1, 1, 1, n_episodes=8, device="cpu", n_episodes_5shot=4)
    assert list(res) == KEYS
    assert all(0.0 <= v <= 1.0 for v in res.values()), res
    for run_dir in ("lp_p1/epoch-last", "lp_p2/epoch-last", "lp_p3/max-va", "lp_p4/max-va"):
        assert (tmp_path / run_dir / "meta.json").is_file(), run_dir


def test_reproducible_pins_the_numerics_and_restores_them():
    """Inside ``reproducible()``: cuDNN deterministic, no autotuning, TF32
    off for convolutions and matmuls; after it, the caller's flags again,
    also when the body raises."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = (
        False, True, True, True)
    try:
        with pytest.raises(ValueError):
            with lp.reproducible():
                assert (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
                        matmul.allow_tf32) == (True, False, False, False)
                raise ValueError
        assert (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
                matmul.allow_tf32) == (False, True, True, True)
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = before
