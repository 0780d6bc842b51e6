"""Port parity, the precision gate: ``fewshot_vit_tpu_torch/tools/
precision_check.py`` against the repository's ``tools/precision_check.py``
(read with ``ast``: it imports JAX at call time). The gate's numbers come
from the card (``chip_smoke.py`` phase 33); here the episode regrouping, the
printed keys and the knobs are held to JAX's, at a small size on the CPU."""

import ast
import json
import pathlib

import numpy as np
import torch

from fewshot_vit_tpu_torch.data.datasets import synthetic
from fewshot_vit_tpu_torch.eval.episodic import evaluate, sample_episode_indices
from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline
from fewshot_vit_tpu_torch.models.visformer import Visformer
from fewshot_vit_tpu_torch.tools import precision_check as pc

from .torch_port_helpers import SMALL_VISFORMER

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_TOOL = ROOT / "tools" / "precision_check.py"
DATA = dict(n_classes=6, n_per_class=20, image_size=80, seed=0)
EP_LEN = pc.WAY * (pc.SHOT + pc.QUERY)


def _small_head(dtype, device):
    return MetaBaseline(Visformer(**SMALL_VISFORMER, use_pallas_attn=True, dtype=dtype,
                                  device=device, seed=0)).eval()


def test_regrouping_leaves_every_episode_untouched():
    """The fp32 run's batches are the bf16 draw's flat episode blocks
    regrouped: episode for episode the same indices in the same order, and
    (fp32, eval mode) the same per-episode accuracies as the draw's own
    grouping."""
    ds = synthetic(**DATA)
    idx = sample_episode_indices(ds, 8, pc.WAY, pc.SHOT + pc.QUERY, 4, seed=pc.SEED)
    fp32 = pc.regroup(idx, 2, EP_LEN)
    assert fp32.shape == (4, 2 * EP_LEN)
    np.testing.assert_array_equal(fp32.reshape(-1, EP_LEN), idx.reshape(-1, EP_LEN))
    head = _small_head(torch.float32, "cpu")
    kw = dict(n_episodes=8, way=pc.WAY, shot=pc.SHOT, query=pc.QUERY, device="cpu")
    whole = evaluate(head, ds, ep_per_batch=4, indices=idx, **kw)[2]
    regrouped = evaluate(head, ds, ep_per_batch=2, indices=fp32, **kw)[2]
    np.testing.assert_array_equal(regrouped, whole)


def _jax_tool():
    """JAX's printed keys (in order) and its env knobs with their defaults."""
    tree = ast.parse(JAX_TOOL.read_text())
    keys, knobs = [], {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].value, "id", "") == "out"):
            key = node.targets[0].slice
            if isinstance(key, ast.JoinedStr):  # f"acc_{name}" inside the precision loop
                prefix = key.values[0].value
                keys.append(lambda name, prefix=prefix: prefix + name)
            else:
                keys.append(key.value)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "get"
              and getattr(getattr(node.func, "value", None), "attr", "") == "environ"):
            knobs[node.args[0].value] = node.args[1].value
    names = ("fp32", "bf16")
    loop = [k for k in keys if callable(k)]
    return [f(n) for n in names for f in loop] + [k for k in keys if not callable(k)], knobs


def test_keys_and_knobs_equal_jax(monkeypatch, capsys):
    want_keys, want_knobs = _jax_tool()
    got = pc.run(device="cpu", n_episodes=4, epb=4, epb_fp32=2, dataset=synthetic(**DATA),
                 make_head=_small_head)
    assert list(got) == want_keys
    assert got["n_episodes"] == 4 and got["abs_diff"] == round(abs(
        got["acc_fp32"] - got["acc_bf16"]), 6)
    assert 0.0 <= got["acc_bf16"] <= 1.0 and 0.0 <= got["acc_fp32"] <= 1.0
    # the knobs: JAX's names and defaults, read by main() into run()
    seen = {}
    monkeypatch.setattr(pc, "watchdog_reexec", lambda timeout_s: None)
    monkeypatch.setattr(pc, "run", lambda **kw: seen.update(kw) or {"ok": 1})
    pc.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == {"ok": 1}
    assert want_knobs == {"PRECHECK_EPISODES": 512, "PRECHECK_EPB": 128,
                          "PRECHECK_EPB_FP32": 64}
    assert (seen["n_episodes"], seen["epb"], seen["epb_fp32"]) == (512, 128, 64)
    monkeypatch.setenv("PRECHECK_EPISODES", "8")
    monkeypatch.setenv("PRECHECK_EPB_FP32", "4")
    pc.main(["--device", "cpu"])
    assert (seen["n_episodes"], seen["epb"], seen["epb_fp32"], seen["device"]) == (
        8, 128, 4, "cpu")
