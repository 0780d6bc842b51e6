"""Port parity, the bench entry: ``fewshot_vit_tpu_torch/bench.py`` against
the repository's ``bench.py`` protocol (JAX's ``fold_encoder_in_head`` /
``quantize_encoder_in_head`` + ``evaluate``), same flax weights carried
across, same episodes. ``bench.py`` itself imports JAX at call time and is
read here with ``ast``, never imported."""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.data.datasets import synthetic as j_synthetic
from fewshot_vit_tpu.data.transforms import normalize as j_normalize
from fewshot_vit_tpu.eval.episodic import evaluate as j_evaluate
from fewshot_vit_tpu.heads.meta_baseline import MetaBaseline as JMetaBaseline
from fewshot_vit_tpu.models.fold import fold_encoder_in_head as j_fold
from fewshot_vit_tpu.models.quant import quantize_encoder_in_head as j_quantize
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu_torch import bench
from fewshot_vit_tpu_torch.checkpoint import load_flax
from fewshot_vit_tpu_torch.data.datasets import synthetic as t_synthetic
from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline as TMetaBaseline
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.ops.metric import mean_confidence_interval

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
N_EP, EPB = 16, 8
N_INT8 = 8  # one batch: the int8 products run slowly on the CPU
DATA = dict(n_classes=10, n_per_class=30, image_size=80, seed=0)
SMALL_DATA = dict(n_classes=5, n_per_class=16, image_size=80, seed=0)


@pytest.fixture(scope="module")
def weights():
    """A SMALL MetaBaseline's flax variables with non-trivial BN statistics."""
    jhead = JMetaBaseline(encoder=JVisformer(**SMALL_VISFORMER))
    variables = randomize_bn(numpy_tree(jhead.init(
        jax.random.key(1), jnp.zeros((1, 2, 1, 80, 80, 3)), jnp.zeros((1, 2, 80, 80, 3)))))
    return jhead, variables


def _port_head(variables):
    """The bench's head at SMALL width: the MHSA kernel's dispatch on, as the
    bench runs it (its plain version here, on CPU tensors)."""
    return lambda: load_flax(TMetaBaseline(TVisformer(**SMALL_VISFORMER, use_pallas_attn=True,
                                                      device="cpu")), variables)


def _jax_accs(jhead, jvars, seed, n_episodes=N_EP):
    return np.asarray(j_evaluate(jhead, jvars, j_synthetic(**DATA), n_episodes=n_episodes,
                                 way=5, shot=1, query=15, ep_per_batch=EPB, seed=seed)[2])


def test_bench_pipeline_bit_identical_to_jax(weights):
    """Fold, seeded episodes (the timed pass's seed 2), ``evaluate``, fp32:
    per-episode accuracies equal to JAX's."""
    jhead, variables = weights
    result, accs = bench.run(device="cpu", n_episodes=N_EP, ep_per_batch=EPB,
                             dataset=t_synthetic(**DATA), make_head=_port_head(variables))
    fh, fv = j_fold(jhead, variables)
    want = _jax_accs(fh, fv, bench.TIMED_SEED)
    assert accs.shape == (N_EP,)
    np.testing.assert_array_equal(accs, want)
    assert result["value"] > 0 and result["metric"] == bench.METRIC


def test_bench_int8_against_jax(weights):
    """``--int8``: the same 256-image calibration draw (``default_rng(0)``,
    sorted), fold + quantize with calibrated scales, against JAX's
    ``quantize_encoder_in_head``. The whole-encoder int8 rule of the
    ``--int8`` CLI's test: the mean accuracy equal as printed, the half-width
    within 0.2 points."""
    jhead, variables = weights
    tds, jds = t_synthetic(**DATA), j_synthetic(**DATA)
    result, accs = bench.run(int8=True, device="cpu", n_episodes=N_INT8, ep_per_batch=EPB,
                             dataset=tds, make_head=_port_head(variables))
    idx = np.sort(np.random.default_rng(0).choice(len(jds.images), size=min(256, len(jds.images)),
                                                  replace=False))
    np.testing.assert_array_equal(
        bench.calibration_batch(tds, "cpu").numpy(),
        np.asarray(j_normalize(jnp.asarray(jds.images[idx]), jds.mean, jds.std)))
    calib = j_normalize(jnp.asarray(jds.images[idx]), jds.mean, jds.std)
    qh, qv = j_quantize(jhead, variables, calib_images=calib)
    want = _jax_accs(qh, qv, bench.TIMED_SEED, N_INT8)
    (m, h), (jm, jh) = mean_confidence_interval(accs), mean_confidence_interval(want)
    assert round(m * 100, 2) == round(jm * 100, 2), (m, jm)
    assert abs(h - jh) * 100 <= 0.2, (h, jh)
    assert result["metric"] == bench.METRIC + "_int8_experimental"


def _bench_py():
    """What ``bench.py`` reports, read from its source: the metric name and
    its int8 suffix, the returned dict's keys and unit, the target per chip,
    the warm and timed seeds, the protocol constants and the watchdog's
    budget."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    out = {"seeds": []}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name in ("name", "ep_per_batch", "n_episodes", "target_per_chip"):
                out[name] = eval(compile(ast.Expression(node.value), "bench.py", "eval"))
        elif isinstance(node, ast.AugAssign) and getattr(node.target, "id", "") == "name":
            out["suffix"] = node.value.value
        elif isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            out["keys"] = [k.value for k in node.value.keys]
            out["unit"] = dict(zip(out["keys"], node.value.values))["unit"].value
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "evaluate":
            out["seeds"] += [k.value.value for k in node.keywords if k.arg == "seed"]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "watchdog_reexec":
            out["watchdog_s"] = node.keywords[0].value.value
    return out


def test_fields_and_names_equal_bench_py(monkeypatch, capsys):
    want = _bench_py()
    assert (bench.METRIC, bench.UNIT) == (want["name"], want["unit"])
    assert bench.TARGET_PER_CHIP == want["target_per_chip"]
    assert (bench.EP_PER_BATCH, bench.N_EPISODES) == (want["ep_per_batch"], want["n_episodes"])
    assert [bench.WARM_SEED, bench.TIMED_SEED] == want["seeds"]
    budgets = []
    monkeypatch.setattr(bench, "watchdog_reexec", lambda timeout_s: budgets.append(timeout_s))
    small = dict(device="cpu", n_episodes=2, ep_per_batch=2, dataset=t_synthetic(**SMALL_DATA),
                 make_head=lambda: TMetaBaseline(TVisformer(**SMALL_VISFORMER, device="cpu")))
    real = bench.measure
    monkeypatch.setattr(bench, "measure", lambda int8, device: real(int8=int8, **small))
    for argv, suffix in (([], ""), (["--int8"], want["suffix"])):
        bench.main(argv)
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1
        got = json.loads(lines[0])
        assert list(got) == want["keys"]
        assert got["metric"] == want["name"] + suffix and got["unit"] == want["unit"]
        # both rounded, as bench.py rounds them
        assert abs(got["vs_baseline"] - got["value"] / want["target_per_chip"]) < 1e-3
    assert budgets == [want["watchdog_s"]] * 2


def test_bench_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.measure()
