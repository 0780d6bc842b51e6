"""Port parity, the slice as a whole: MetaBaseline episodic eval of a narrow
Visformer on the synthetic dataset, JAX ``evaluate`` against the port's,
same weights (carried across) and same seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.data.datasets import synthetic as j_synthetic
from fewshot_vit_tpu.eval.episodic import evaluate as j_evaluate
from fewshot_vit_tpu.heads.meta_baseline import MetaBaseline as JMetaBaseline
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu_torch.checkpoint import load_flax
from fewshot_vit_tpu_torch.data.datasets import synthetic as t_synthetic
from fewshot_vit_tpu_torch.data.transforms import normalize
from fewshot_vit_tpu_torch.eval.episodic import (
    evaluate as t_evaluate,
    evaluate_cached,
    sample_episode_indices,
)
from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline as TMetaBaseline
from fewshot_vit_tpu_torch.models.fold import fold_encoder_in_head
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.ops.episodes import split_shot_query

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
WAY, SHOT, QUERY, EPB, N_EP, SEED = 5, 1, 15, 4, 16, 7


@pytest.fixture(scope="module")
def setup():
    ds_kw = dict(n_classes=10, n_per_class=20, image_size=80, seed=0)
    jds, tds = j_synthetic(**ds_kw), t_synthetic(**ds_kw)
    jhead = JMetaBaseline(encoder=JVisformer(**SMALL_VISFORMER))
    xs0 = jnp.zeros((1, 2, 1, 80, 80, 3), jnp.float32)
    xq0 = jnp.zeros((1, 2, 80, 80, 3), jnp.float32)
    variables = randomize_bn(numpy_tree(jhead.init(jax.random.key(1), xs0, xq0)))
    thead = load_flax(TMetaBaseline(TVisformer(**SMALL_VISFORMER, device="cpu")), variables)
    t_result = t_evaluate(thead, tds, n_episodes=N_EP, way=WAY, shot=SHOT, query=QUERY,
                          ep_per_batch=EPB, seed=SEED, device="cpu")
    return jds, tds, jhead, variables, thead, t_result


def test_episode_accuracies_identical_to_jax(setup):
    jds, _, jhead, variables, _, (tm, th, taccs) = setup
    jm, jh, jaccs = j_evaluate(jhead, variables, jds, n_episodes=N_EP, way=WAY,
                               shot=SHOT, query=QUERY, ep_per_batch=EPB, seed=SEED)
    assert taccs.shape == (N_EP,) and taccs.dtype == np.float32
    np.testing.assert_array_equal(taccs, jaccs)
    np.testing.assert_allclose((tm, th), (jm, jh), rtol=1e-12)  # same accs, same float64 math


def test_logits_match_jax(setup):
    _, tds, jhead, variables, thead, _ = setup
    idx = sample_episode_indices(tds, N_EP, WAY, SHOT + QUERY, EPB, SEED)[0]
    x = normalize(torch.from_numpy(tds.images[idx[: WAY * (SHOT + QUERY)]]))  # one episode
    xs, xq = split_shot_query(x, WAY, SHOT, QUERY, 1)
    want = np.asarray(jhead.apply(variables, jnp.asarray(xs.numpy()), jnp.asarray(xq.numpy())))
    with torch.no_grad():
        got = thead(xs, xq)
    assert got.dtype == torch.float32 and got.shape == (1, WAY * QUERY, WAY)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)  # fp32 encoder sums


def test_folded_and_cached_paths_agree(setup):
    """Folding is exact up to fp32 rounding, and the cached-features path
    draws the same episodes, so all give the same accuracies."""
    _, tds, _, _, thead, (_, _, accs) = setup
    kw = dict(way=WAY, shot=SHOT, query=QUERY, ep_per_batch=EPB, seed=SEED, device="cpu")
    folded = fold_encoder_in_head(thead)
    assert folded.temp.item() == thead.temp.item()
    _, _, f_accs = t_evaluate(folded, tds, n_episodes=EPB, **kw)  # the first batch
    np.testing.assert_array_equal(f_accs, accs[:EPB])
    _, _, c_accs = evaluate_cached(thead.encoder, tds, n_episodes=N_EP,
                                   temp=thead.temp.item(), **kw)
    np.testing.assert_array_equal(c_accs, accs)


def test_explicit_indices_and_bad_placement(setup):
    _, tds, _, _, thead, (_, _, accs) = setup
    idx = sample_episode_indices(tds, N_EP, WAY, SHOT + QUERY, EPB, SEED)[:1]
    _, _, a = t_evaluate(thead, tds, n_episodes=EPB, ep_per_batch=EPB, indices=idx,
                         device="cpu")
    np.testing.assert_array_equal(a, accs[:EPB])
    with pytest.raises(ValueError):
        t_evaluate(thead, tds, n_episodes=4, ep_per_batch=EPB, device="meta")
