"""Port parity, DeepEMD: grid patches, node math, EMD logits, SFC and the
head's ``encode_nodes`` against the JAX package, same numpy inputs and
JAX-initialized weights carried across with ``load_flax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.data import patches as jp
from fewshot_vit_tpu.heads import deepemd as jd
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu_torch.checkpoint import load_flax
from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.data import patches as tp
from fewshot_vit_tpu_torch.heads import deepemd as td
from fewshot_vit_tpu_torch.kernels import sinkhorn as tks
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.ops import emd as temd
from fewshot_vit_tpu_torch.train.meta_tune_emd import make_patch_fn

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
TOL = 1e-4  # fp32 einsums / exp / log summed in another order than XLA:CPU


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("size", [80, 84])
@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("ratio", [2.0, 1.8, 1.0, 3.0])
def test_grid_boxes_exact_equal(size, g, ratio):
    for a, b in zip(tp._grid_boxes_exact(size, g, ratio), jp._grid_boxes_exact(size, g, ratio)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ratio", [2.0, 1.0])
def test_grid_patches_match_jax(ratio):
    images = np.random.default_rng(0).integers(0, 256, (2, 80, 80, 3)).astype(np.uint8)
    want = np.asarray(jp.grid_patches(jnp.asarray(images), (2, 3), ratio, 80))
    got = tp.grid_patches(torch.from_numpy(images), (2, 3), ratio, 80)
    assert got.shape == (2, 13, 80, 80, 3) and got.dtype == torch.float32
    # 0-255 scale; at most 4 nonzero taps per output, summed in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_training_only_patch_paths_raise():
    """Only on malformed input: the train-time paths themselves run (their
    parity with JAX is in ``tests/test_torch_sund_train.py``)."""
    images = torch.zeros(2, 80, 80, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="n_levels"):
        tp.grid_patches(images, (2, 3), torch.tensor([[2.0, 2.0]]))
    with pytest.raises(ValueError):
        make_patch_fn("mosaic", [2, 3], 2.0, 80, train=True)
    gen = torch.Generator().manual_seed(0)
    assert tp.draw_grid_ratios(gen, 2, 2).shape == (2, 2)
    assert tp.sampling_patches(gen, images, 3, 16).shape == (2, 3, 16, 16, 3)
    assert make_patch_fn("grid", [2, 3], 2.0, 40, train=True)(images, gen).shape == (
        2, 13, 40, 40, 3)
    assert make_patch_fn("sampling", [2, 3], 2.0, 40, train=False, num_patch=4)(
        images, gen).shape == (2, 4, 40, 40, 3)


def test_weight_vector_matches_jax():
    a, b = _rand(1, 2, 4, 13, 16), _rand(2, 2, 3, 13, 16)
    _close(td.weight_vector(torch.from_numpy(a), torch.from_numpy(b)),
           jd.weight_vector(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("sizes", [(2, 1), (2, 3)])
def test_pyramid_nodes_match_jax(sizes):
    dense = _rand(3, 2, 5, 5, 16)
    got = td.pyramid_nodes(torch.from_numpy(dense), sizes)
    assert got.shape == (2, sum(s * s for s in sizes) + 25, 16)
    _close(got, jd.pyramid_nodes(jnp.asarray(dense), sizes))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_similarity_map_matches_jax(metric):
    proto, query = _rand(4, 2, 3, 13, 16), _rand(5, 2, 6, 13, 16)
    got = td.similarity_map(torch.from_numpy(proto), torch.from_numpy(query), metric)
    assert got.shape == (2, 6, 3, 13, 13)
    _close(got, jd.similarity_map(jnp.asarray(proto), jnp.asarray(query), metric))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("n", [13, 25])
def test_emd_logits_match_jax(monkeypatch, impl, n):
    """Both dispatches against the JAX function; JAX's Pallas kernel runs in
    interpret mode, as the JAX package's own dispatch test runs it."""
    import fewshot_vit_tpu.kernels.sinkhorn as jks

    orig = jks.sinkhorn_pallas
    monkeypatch.setattr(jks, "sinkhorn_pallas",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    proto, query = _rand(6, 2, 3, n, 16), _rand(7, 2, 6, n, 16)
    want = jd.emd_logits(jnp.asarray(proto), jnp.asarray(query), solver_impl=impl)
    got = td.emd_logits(torch.from_numpy(proto), torch.from_numpy(query), solver_impl=impl)
    assert got.shape == (2, 6, 3) and got.dtype == torch.float32
    _close(got, want)


def test_emd_logits_exact_solver_is_queued():
    """The queued solver is in: ``solver_impl='exact'`` (the C++ simplex on
    the host) gives JAX's exact logits (``pure_callback`` on the CPU)."""
    proto, query = _rand(10, 2, 3, 9, 16), _rand(11, 2, 6, 9, 16)
    want = jd.emd_logits(jnp.asarray(proto), jnp.asarray(query), solver_impl="exact")
    got = td.emd_logits(torch.from_numpy(proto), torch.from_numpy(query), solver_impl="exact")
    assert got.shape == (2, 6, 3) and got.dtype == torch.float32
    _close(got, want)


def test_emd_logits_gradient_only_through_sim():
    """Flows are constants: the gradient equals the one of sum(sim * flow)
    with the flow computed beforehand and held fixed, for both dispatches."""
    proto = torch.from_numpy(_rand(8, 3, 9, 16)).requires_grad_(True)
    query = torch.from_numpy(_rand(9, 4, 9, 16))
    sim = td.similarity_map(td.center_normalize(proto), td.center_normalize(query))
    with torch.no_grad():
        w1 = temd.normalize_weights(td.weight_vector(query, proto))
        w2 = temd.normalize_weights(td.weight_vector(proto, query).transpose(-2, -3))
        flow = temd.sinkhorn(1.0 - sim, w1, w2)
    (want,) = torch.autograd.grad(temd.emd_distance(sim, flow, 12.5).sum(), proto)
    assert torch.isfinite(want).all() and want.abs().max() > 0
    for impl in ("xla", "pallas"):
        (got,) = torch.autograd.grad(td.emd_logits(proto, query, solver_impl=impl).sum(), proto)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lr", [0.1, 5.0])
def test_sfc_refine_matches_jax(lr):
    way, shot, steps, n, c = 3, 2, 3, 9, 16
    support = _rand(10, way * shot, n, c)
    proto0 = support.reshape(shot, way, n, c).mean(0)
    perms = np.stack([np.random.default_rng(11 + s).permutation(way * shot)
                      for s in range(steps)]).astype(np.int32)
    want = jd.sfc_refine(jnp.asarray(proto0), jnp.asarray(support), way, shot,
                         jax.random.key(0), steps=steps, lr=lr, batch_size=4,
                         perms=jnp.asarray(perms))
    got = td.sfc_refine(torch.from_numpy(proto0)[None], torch.from_numpy(support)[None],
                        way, shot, lr=lr, batch_size=4,
                        perms=torch.from_numpy(perms.astype(np.int64))[None])
    assert got.shape == (1, way, n, c) and not got.requires_grad
    assert (got[0] - torch.from_numpy(proto0)).abs().max() > 1e-4  # it moved
    _close(got[0], want)


def test_sfc_shuffles_follow_the_global_episode_index():
    a = td.sfc_perms([0, 1, 2], 4, 10, seed=5)
    b = td.sfc_perms([2], 4, 10, seed=5)
    assert a.shape == (3, 4, 10)
    torch.testing.assert_close(a[2:], b, rtol=0, atol=0)
    assert not torch.equal(a[0], a[1])
    assert all(sorted(p.tolist()) == list(range(10)) for p in a.reshape(-1, 10))


@pytest.fixture(scope="module")
def heads():
    jhead = jd.DeepEMD(encoder=JVisformer(**SMALL_VISFORMER))
    variables = randomize_bn(numpy_tree(
        jhead.init(jax.random.key(2), jnp.zeros((1, 80, 80, 3), jnp.float32))))
    thead = load_flax(td.DeepEMD(TVisformer(**SMALL_VISFORMER, device="cpu")), variables)
    return jhead, variables, thead


@pytest.mark.parametrize("shape", [(3, 80, 80, 3), (2, 3, 80, 80, 3)])
def test_encode_nodes_matches_jax(heads, shape):
    jhead, variables, thead = heads
    x = _rand(12, *shape)
    want = jhead.apply(variables, jnp.asarray(x), method=jhead.encode_nodes)
    with torch.no_grad():
        got = thead.encode_nodes(torch.from_numpy(x))
    assert got.shape == ((3, 25, 192) if len(shape) == 4 else (2, 3, 192))
    _close(got, want)


def test_load_flax_is_strict_clean_for_the_head(heads):
    _, variables, thead = heads
    fresh = td.DeepEMD(TVisformer(**SMALL_VISFORMER, device="cpu"))
    missing, unexpected = fresh.load_state_dict(thead.state_dict(), strict=True)
    assert not missing and not unexpected
    assert load_flax(fresh, variables) is fresh


@pytest.mark.parametrize("alias,canonical", [("opencv", "sinkhorn_detached"),
                                             ("sinkhorn", "sinkhorn_detached"),
                                             ("qpth", "sinkhorn_unrolled")])
def test_legacy_solver_aliases_warn_and_resolve(alias, canonical):
    with pytest.warns(UserWarning, match="legacy alias"):
        assert td._canonical_solver(alias) == canonical
    with pytest.warns(UserWarning, match="legacy alias"):
        head = td.make_deepemd(encoder_args=dict(SMALL_VISFORMER), solver=alias,
                               device="cpu")
    assert head.solver == canonical
    with pytest.raises(ValueError, match="unknown solver"):
        td._canonical_solver("simplex")


def test_make_deepemd_registered_and_pretrain_queued():
    """``n_classes`` is no longer queued: it builds the pretrain ``fc``."""
    head = models.make("deepemd", encoder_args=dict(SMALL_VISFORMER),
                       solver="sinkhorn_pallas", device="cpu")
    assert isinstance(head, td.DeepEMD) and head.solver == "sinkhorn_pallas"
    assert not head.training and not hasattr(head, "fc")
    pre = td.make_deepemd(encoder_args=dict(SMALL_VISFORMER), n_classes=64, device="cpu")
    assert tuple(pre.fc.weight.shape) == (64, 192) and not pre.fc.bias.any()
    with torch.no_grad():
        x = torch.from_numpy(_rand(15, 2, 80, 80, 3))
        assert pre.pre_train(x).shape == (2, 64)
        torch.testing.assert_close(pre(x), pre.pre_train(x))
    again = td.make_deepemd(encoder_args=dict(SMALL_VISFORMER), n_classes=64, device="cpu")
    torch.testing.assert_close(again.fc.weight, pre.fc.weight, rtol=0, atol=0)


def test_head_meta_dispatch_counts_no_cpu_launch(heads):
    _, _, thead = heads
    proto, query = torch.from_numpy(_rand(13, 2, 3, 13, 16)), torch.from_numpy(_rand(14, 2, 4, 13, 16))
    before = tks.sinkhorn_pallas.launches
    thead.solver = "sinkhorn_pallas"
    try:
        got = thead.meta(proto, query)
    finally:
        thead.solver = "sinkhorn_detached"
    # the flat (B, N, N) batch vectorizes the same sums another way on the CPU
    torch.testing.assert_close(got, thead.meta(proto, query), rtol=1e-5, atol=1e-5)
    assert tks.sinkhorn_pallas.launches == before
