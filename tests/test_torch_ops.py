"""Port parity, metric ops: logits, normalization, accuracy, CI."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.ops import episodes as jep
from fewshot_vit_tpu.ops import metric as jm
from fewshot_vit_tpu_torch.ops import episodes as tep
from fewshot_vit_tpu_torch.ops import metric as tm

torch.set_num_threads(1)
RTOL = 1e-6  # fp32 rounding of a 24-wide reduction


@pytest.mark.parametrize("metric", ["dot", "cos", "sqr"])
def test_compute_logits(metric):
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(3, 15, 24)).astype(np.float32)
    proto = rng.normal(size=(3, 5, 24)).astype(np.float32)
    want = np.asarray(jm.compute_logits(jnp.asarray(feat), jnp.asarray(proto), metric, 10.0))
    got = tm.compute_logits(torch.from_numpy(feat), torch.from_numpy(proto), metric, 10.0).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_compute_logits_unknown_metric():
    with pytest.raises(ValueError):
        tm.compute_logits(torch.zeros(2, 3), torch.zeros(4, 3), "l1")


def test_l2_normalize_with_zero_row():
    x = np.random.default_rng(1).normal(size=(4, 9)).astype(np.float32)
    x[2] = 0.0  # the eps clamp: a zero row stays zero
    want = np.asarray(jm.l2_normalize(jnp.asarray(x)))
    got = tm.l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    assert not np.any(got[2])


def test_per_episode_acc_with_ties():
    rng = np.random.default_rng(2)
    logits = rng.integers(0, 3, size=(6, 15, 5)).astype(np.float32)  # many ties: first max wins
    label = np.array(jep.make_nk_label(5, 3, 6))
    np.testing.assert_array_equal(tep.make_nk_label(5, 3, 6).numpy(), label)
    want = np.asarray(jm.per_episode_acc(jnp.asarray(logits), jnp.asarray(label)))
    got = tm.per_episode_acc(torch.from_numpy(logits), torch.from_numpy(label)).numpy()
    np.testing.assert_array_equal(got, want)


def test_split_shot_query():
    x = np.arange(2 * 5 * 4 * 3).reshape(2 * 5 * 4, 3)
    js, jq = jep.split_shot_query(jnp.asarray(x), 5, 1, 3, 2)
    ts, tq = tep.split_shot_query(torch.from_numpy(x), 5, 1, 3, 2)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("n", [1, 2, 37])
def test_mean_confidence_interval(n):
    accs = np.random.default_rng(n).uniform(0, 1, n)
    want = jm.mean_confidence_interval(accs)
    got = tm.mean_confidence_interval(accs)
    np.testing.assert_allclose(got, want, rtol=RTOL)
