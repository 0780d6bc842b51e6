"""Port parity, the slice as a whole: SUN-D episodic eval of a narrow
DeepEMD on the synthetic dataset, the JAX ``make_emd_episode_fn`` +
``make_emd_eval_run_fn`` against the port's ``evaluate_emd``, same weights
(carried across) and the same interleaved episode indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.data.datasets import synthetic as j_synthetic
from fewshot_vit_tpu.eval.emd_eval import (
    group_episode_indices as j_group,
    make_emd_eval_run_fn as j_run_fn,
)
from fewshot_vit_tpu.heads.deepemd import DeepEMD as JDeepEMD
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.ops.metric import normal_confidence_interval as j_normal_ci
from fewshot_vit_tpu.train.meta_tune_emd import (
    make_emd_episode_fn as j_episode_fn,
    make_patch_fn as j_patch_fn,
)
from fewshot_vit_tpu_torch.checkpoint import load_flax
from fewshot_vit_tpu_torch.data.datasets import synthetic as t_synthetic
from fewshot_vit_tpu_torch.eval.emd_eval import (
    evaluate_emd,
    group_episode_indices,
    sample_emd_episode_indices,
)
from fewshot_vit_tpu_torch.heads.deepemd import DeepEMD as TDeepEMD
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.train.meta_tune_emd import (
    make_emd_episode_fn as t_episode_fn,
    make_patch_fn as t_patch_fn,
)

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
WAY, SHOT, QUERY, EPB, N_EP, SEED = 3, 1, 2, 2, 4, 5


@pytest.fixture(scope="module")
def setup():
    ds_kw = dict(n_classes=10, n_per_class=20, image_size=80, seed=0)
    jds, tds = j_synthetic(**ds_kw), t_synthetic(**ds_kw)
    jhead = JDeepEMD(encoder=JVisformer(**SMALL_VISFORMER))
    variables = randomize_bn(numpy_tree(
        jhead.init(jax.random.key(4), jnp.zeros((1, 80, 80, 3), jnp.float32))))
    thead = load_flax(TDeepEMD(TVisformer(**SMALL_VISFORMER, device="cpu")), variables)
    idx = sample_emd_episode_indices(tds, N_EP, WAY, SHOT + QUERY, SEED)
    return jds, tds, jhead, variables, thead, idx


def _jax_run(jds, jhead, variables, idx, mode):
    patch_fn = j_patch_fn(mode, [2, 3], 9, 2.0, 80, False)
    ep_fn = j_episode_fn(jhead, WAY, SHOT, QUERY, patch_fn, jds.mean, jds.std, sfc=False)
    run = j_run_fn(ep_fn, jnp.tile(jnp.arange(WAY), QUERY))
    accs = run(variables, jnp.asarray(jds.images), jnp.asarray(j_group(idx, EPB)),
               jax.random.key(0))
    return np.asarray(accs)[: len(idx)]


def _port(tds, thead, idx, mode, **kw):
    kw = {"ep_per_batch": EPB, **kw}
    return evaluate_emd(thead, tds, way=WAY, shot=SHOT, query=QUERY, mode=mode,
                        indices=idx, device="cpu", **kw)


def test_indices_are_the_jax_protocol(setup):
    """One sampler batch per episode from np_rng(seed), reordered class-major
    -> item-major, exactly as the JAX SUN-D eval draws them."""
    from fewshot_vit_tpu.core import rng as j_rng
    from fewshot_vit_tpu.data.sampler import EpisodeSampler as JSampler

    _, tds, _, _, _, idx = setup
    raw = np.stack(list(JSampler(tds.labels, N_EP, WAY, SHOT + QUERY, 1)
                        .epoch(j_rng.np_rng(SEED))))
    want = raw.reshape(N_EP, WAY, SHOT + QUERY).transpose(0, 2, 1).reshape(N_EP, -1)
    np.testing.assert_array_equal(idx, want)
    assert idx.dtype == np.int32
    np.testing.assert_array_equal(group_episode_indices(idx[:3], 2), j_group(idx[:3], 2))


@pytest.mark.parametrize("mode", ["grid", "fcn"])
def test_episode_accuracies_identical_to_jax(setup, mode):
    jds, tds, jhead, variables, thead, idx = setup
    want = _jax_run(jds, jhead, variables, idx, mode)
    m, h, accs = _port(tds, thead, idx, mode)
    assert accs.shape == (N_EP,) and accs.dtype == np.float32
    np.testing.assert_array_equal(accs, want)
    np.testing.assert_allclose((m, h), j_normal_ci(want), rtol=1e-12)


@pytest.mark.parametrize("mode", ["grid", "fcn"])
def test_logits_match_jax(setup, mode):
    jds, tds, jhead, variables, thead, idx = setup
    patch_fn = j_patch_fn(mode, [2, 3], 9, 2.0, 80, False)
    j_fn = j_episode_fn(jhead, WAY, SHOT, QUERY, patch_fn, jds.mean, jds.std, sfc=False)
    want = np.asarray(j_fn(variables, jnp.asarray(jds.images[idx[0]]), jax.random.key(0)))
    t_fn = t_episode_fn(thead, WAY, SHOT, QUERY, t_patch_fn(mode, [2, 3], 2.0, 80, False),
                        tds.mean, tds.std, sfc=False)
    with torch.no_grad():
        got = t_fn(torch.from_numpy(tds.images[idx[:1]]), [0])
    assert got.shape == (1, WAY * QUERY, WAY) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-4, atol=1e-4)


def test_cached_equals_direct_and_grouping_is_invisible(setup):
    _, tds, _, _, thead, idx = setup
    _, _, direct = _port(tds, thead, idx, "fcn")
    _, _, cached = _port(tds, thead, idx, "fcn", cached=True)
    np.testing.assert_array_equal(cached, direct)
    _, _, one = _port(tds, thead, idx, "fcn", ep_per_batch=1)
    np.testing.assert_array_equal(one, direct)
    _, _, padded = _port(tds, thead, idx[:3], "fcn", ep_per_batch=2)  # 3 -> 4, last repeated
    np.testing.assert_array_equal(padded, direct[:3])


def test_cached_equals_direct_grid(setup):
    thead = setup[4]
    small = t_synthetic(n_classes=4, n_per_class=6, image_size=80, seed=1)
    idx = sample_emd_episode_indices(small, 2, WAY, SHOT + QUERY, SEED)
    _, _, direct = _port(small, thead, idx, "grid")
    _, _, cached = _port(small, thead, idx, "grid", cached=True)
    np.testing.assert_array_equal(cached, direct)


def test_five_shot_with_sfc_runs(setup):
    """Not bit-compared: the JAX shuffles come from its PRNG, the port's
    from torch.Generators seeded by the global episode index."""
    _, tds, _, _, thead, _ = setup
    sfc_kw = {"steps": 2, "lr": 100.0, "batch_size": 4}
    m, h, accs = evaluate_emd(thead, tds, way=WAY, shot=5, query=QUERY, n_episodes=2,
                              ep_per_batch=2, mode="fcn", sfc_kw=sfc_kw, seed=SEED,
                              device="cpu")
    assert accs.shape == (2,) and np.isfinite(accs).all() and np.isfinite(h)
    assert ((accs >= 0) & (accs <= 1)).all()
    _, _, again = evaluate_emd(thead, tds, way=WAY, shot=5, query=QUERY, n_episodes=2,
                               ep_per_batch=1, mode="fcn", sfc_kw=sfc_kw, seed=SEED,
                               device="cpu")
    np.testing.assert_array_equal(again, accs)


def test_sampling_mode_and_placement_are_refused(setup):
    """``sampling`` now evaluates (random crops seeded per episode), except
    cached, where it is refused; a wrong placement is refused as before."""
    _, tds, _, _, thead, idx = setup
    _, _, accs = _port(tds, thead, idx[:2], "sampling", ep_per_batch=1, num_patch=3)
    assert accs.shape == (2,) and ((accs >= 0) & (accs <= 1)).all()
    _, _, again = _port(tds, thead, idx[:2], "sampling", ep_per_batch=1, num_patch=3)
    np.testing.assert_array_equal(again, accs)  # the crops are seeded
    with pytest.raises(ValueError, match="cannot be cached"):
        _port(tds, thead, idx, "sampling", cached=True)
    with pytest.raises(ValueError):
        evaluate_emd(thead, tds, n_episodes=1, device="meta")
