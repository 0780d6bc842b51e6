"""Port parity, SUN-D meta-tuning: the train-time patch pipelines with the
draws injected, one training episode's loss and gradients for each solver,
the task batch's NaN rule, a two-epoch trajectory, SFC under grad mode, and
the CLI on ``--device cpu``. The JAX Pallas kernel runs in interpret mode."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import fewshot_vit_tpu.kernels.sinkhorn as jks
from fewshot_vit_tpu.core.config import Config as JConfig
from fewshot_vit_tpu.data import augment as ja
from fewshot_vit_tpu.data import patches as jp
from fewshot_vit_tpu.heads.deepemd import DeepEMD as JDeepEMD
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.train import meta_tune_emd as jt
from fewshot_vit_tpu.train.state import TrainState as JTrainState
from fewshot_vit_tpu_torch.checkpoint import from_flax, load_flax
from fewshot_vit_tpu_torch.core.config import Config
from fewshot_vit_tpu_torch.data import augment as ta
from fewshot_vit_tpu_torch.data import patches as tp
from fewshot_vit_tpu_torch.heads.deepemd import DeepEMD as TDeepEMD
from fewshot_vit_tpu_torch.kernels import sinkhorn as tks
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.parallel.mesh import make_mesh
from fewshot_vit_tpu_torch.train import meta_tune_emd as tt
from fewshot_vit_tpu_torch.train.runner import parse_args
from fewshot_vit_tpu_torch.train.state import TrainState

from .torch_port_helpers import numpy_tree, randomize_bn

torch.set_num_threads(1)
# Resampling with per-image boxes, 0-255 scale. With the eval path's fixed
# ratio 2 the scales are round numbers and both packages agree within 1e-3;
# with drawn ratios the float32 weight formula itself is ill-conditioned: at
# (80, 80) the JAX result and the port's are each 2.8e-3 off a float64
# evaluation of the same formula on the same boxes, and 3.4e-3 apart.
PATCH_TOL = 1e-2
TINY = dict(img_size=32, init_channels=8, embed_dim=48, depth=(1, 1, 1), num_heads=6)
WAY, SHOT, QUERY = 2, 1, 2
MEAN, STD = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)


def _images(seed, n, size=40):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3)).astype(np.uint8)


# --- patch pipelines ---------------------------------------------------------------


def test_draw_grid_ratios_range_and_shape():
    gen = torch.Generator().manual_seed(0)
    r = tp.draw_grid_ratios(gen, 4000, 2)
    assert r.shape == (4000, 2) and r.dtype == torch.float32
    assert r.min() >= 1.0 and r.max() < 3.0 and abs(r.mean().item() - 2.0) < 0.03
    again = tp.draw_grid_ratios(torch.Generator().manual_seed(0), 4000, 2)
    assert torch.equal(r, again)
    assert not torch.equal(r[:, 0], r[:, 1])  # one draw per image AND level


@pytest.mark.parametrize("size,out", [(40, 24), (80, 80)])
def test_per_image_grid_patches_match_jax(size, out):
    """The same injected (B, n_levels) ratios on both sides, among them 1.0
    (no enlargement), 2.99 (every box clipped at the image border) and draws
    from U[1, 3). ``PATCH_TOL`` on the 0-255 scale."""
    images = _images(0, 5, size)
    ratios = np.array([[1.0, 2.99], [2.99, 1.0], [1.37, 2.2], [2.5, 1.9], [1.81, 2.71]], np.float32)
    want = np.asarray(jp.grid_patches(jnp.asarray(images), (2, 3), jnp.asarray(ratios), out))
    got = tp.grid_patches(torch.from_numpy(images), (2, 3), torch.from_numpy(ratios), out)
    assert got.shape == (5, 13, out, out, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PATCH_TOL)
    for g in (2, 3):  # the boxes themselves
        for a, b in zip(tp._grid_boxes(size, g, torch.from_numpy(ratios[:, 0])),
                        jp._grid_boxes(size, g, jnp.asarray(ratios[:, 0]))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a 0-d ratio broadcasts, as in JAX
    one = tp.grid_patches(torch.from_numpy(images), (2, 3), torch.tensor(1.37), out)
    same = tp.grid_patches(torch.from_numpy(images), (2, 3), torch.full((5, 2), 1.37), out)
    assert torch.equal(one, same)


def _rrc_uniforms(key, b):
    """The four U[0, 1) vectors ``random_resized_crop`` draws from ``key``."""
    return np.stack([np.asarray(jax.random.uniform(k, (b,))) for k in jax.random.split(key, 4)])


def test_random_resized_crop_matches_jax():
    images = _images(1, 6)
    key = jax.random.key(3)
    want = np.asarray(ja.random_resized_crop(key, jnp.asarray(images), 24))
    got = ta.random_resized_crop(None, torch.from_numpy(images), 24,
                                 uniforms=torch.from_numpy(_rrc_uniforms(key, 6)))
    assert got.shape == (6, 24, 24, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PATCH_TOL)
    drawn = ta.random_resized_crop(torch.Generator().manual_seed(1), torch.from_numpy(images), 24)
    assert drawn.shape == got.shape and drawn.min() >= 0 and drawn.max() <= 255


def test_sampling_patches_match_jax():
    images = _images(2, 3)
    key = jax.random.key(5)
    want = np.asarray(jp.sampling_patches(key, jnp.asarray(images), 4, 24))
    uniforms = np.stack([_rrc_uniforms(k, 3) for k in jax.random.split(key, 4)])
    got = tp.sampling_patches(None, torch.from_numpy(images), 4, 24,
                              uniforms=torch.from_numpy(uniforms))
    assert got.shape == (3, 4, 24, 24, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PATCH_TOL)


# --- one training episode ------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jhead = JDeepEMD(encoder=JVisformer(**TINY))
    variables = randomize_bn(numpy_tree(
        jhead.init(jax.random.key(2), jnp.zeros((1, 32, 32, 3), jnp.float32))))
    images = _images(3, 40, 32)
    return variables, images


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX kernel in interpret mode, its inputs detached first: under
    ``jax.grad`` a ``pallas_call`` in interpret mode cannot be linearized
    ("Linearization failed ..."), although its result is a ``stop_gradient``."""
    orig = jks.sinkhorn_pallas
    sg = jax.lax.stop_gradient
    monkeypatch.setattr(jks, "sinkhorn_pallas", lambda cost, w1, w2, **k: orig(
        sg(cost), sg(w1), sg(w2), **{**k, "interpret": True}))


def _j_episode_grads(variables, ep_images, solver, mode, ratios, shot=SHOT, sfc_kw=None):
    jhead = JDeepEMD(encoder=JVisformer(**TINY), solver=solver, solver_iters=20)
    if mode == "grid":
        patch_fn = lambda im, rng: jp.grid_patches(im, (2, 3), jnp.asarray(ratios), 32)
    else:
        patch_fn = jt.make_patch_fn("fcn", [2, 3], 9, 2.0, 32, True)
    fn = jt.make_emd_episode_fn(jhead, WAY, shot, QUERY, patch_fn, MEAN, STD, sfc=shot > 1,
                                sfc_kw=sfc_kw, train=True)
    labels = jnp.tile(jnp.arange(WAY), QUERY)

    def loss_fn(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        logits = fn(v, jnp.asarray(ep_images), jax.random.key(0))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), labels).mean()

    return jax.value_and_grad(loss_fn)(variables["params"])


def _t_episode(variables, solver, mode, shot=SHOT, sfc_kw=None, remat=False):
    head = load_flax(TDeepEMD(TVisformer(**TINY, device="cpu"), solver=solver, solver_iters=20),
                     variables)
    patch_fn = tt.make_patch_fn(mode, [2, 3], 2.0, 32, train=True)
    fn = tt.make_emd_episode_fn(head, WAY, shot, QUERY, patch_fn, MEAN, STD, sfc=shot > 1,
                                sfc_kw=sfc_kw, train=True, remat=remat)
    return head, fn


@pytest.mark.parametrize("solver,mode", [("sinkhorn_detached", "grid"), ("sinkhorn_pallas", "grid"),
                                         ("sinkhorn_unrolled", "fcn"), ("sinkhorn_pallas", "fcn"),
                                         ("sinkhorn_unrolled", "grid")])
def test_training_episode_loss_and_gradients_match_jax(setup, interpret_pallas, solver, mode):
    """Loss within 1e-4; every encoder gradient within 1e-4 of its max-abs
    (floor 1e-6). BN is frozen in SUN-D training, so the statistics must not
    move. ``sinkhorn_unrolled`` differentiates through the 20 iterations."""
    variables, images = setup
    n = WAY * (SHOT + QUERY)
    ep = images[np.random.default_rng(4).permutation(40)[:n]]
    ratios = np.random.default_rng(5).uniform(1.0, 3.0, (n, 2)).astype(np.float32)
    j_loss, j_grads = _j_episode_grads(variables, ep, solver, mode, ratios)

    head, fn = _t_episode(variables, solver, mode)
    before = {k: v.clone() for k, v in head.state_dict().items()}
    launches = tks.sinkhorn_pallas.launches
    draws = {"ratios": torch.from_numpy(ratios)} if mode == "grid" else {}
    logits = fn(torch.from_numpy(ep)[None], [0], **draws)[0]
    assert head.training and logits.shape == (WAY * QUERY, WAY) and logits.requires_grad
    loss = F.cross_entropy(logits.float(), torch.arange(WAY).repeat(QUERY))
    loss.backward()
    assert tks.sinkhorn_pallas.launches == launches  # CPU tensors: the plain version
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=0, atol=1e-4)
    want = from_flax({"params": numpy_tree(j_grads)})
    got = {k: p.grad for k, p in head.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        scale = want[k].abs().max().item()
        assert (g - want[k]).abs().max().item() <= 1e-4 * scale + 1e-6, k
    for k, v in head.state_dict().items():
        assert torch.equal(v, before[k]), k  # nothing moved, BN statistics included


def test_remat_and_seeded_draws(setup):
    """``remat`` changes nothing; with drop-path on, the same key gives the
    same logits and gradients (the mask generator is re-seeded inside the
    checkpointed encoder), another key gives others."""
    variables, images = setup
    ep = torch.from_numpy(images[: WAY * (SHOT + QUERY)])[None]
    outs = {}
    for remat in (False, True):
        head, fn = _t_episode(variables, "sinkhorn_pallas", "grid", remat=remat)
        for blk in head.encoder.stage3:
            blk.drop_path.rate = 0.5
        logits = fn(ep, [0], key=(1, 2, 3))
        logits.sum().backward()
        outs[remat] = (logits.detach(), head.encoder.stem.conv1.weight.grad.clone())
        if not remat:
            with torch.no_grad():
                assert not torch.equal(fn(ep, [0], key=(1, 2, 4)), logits)
    torch.testing.assert_close(outs[True][0], outs[False][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[True][1], outs[False][1], rtol=1e-6, atol=1e-8)


def test_two_shot_episode_with_sfc_under_grad_mode(setup):
    """SFC runs its own autograd inside the training forward; the refined
    prototype is outside the graph, so the loss reaches the encoder through
    the query nodes only. Same injected shuffles on both sides."""
    variables, images = setup
    shot, n = 2, WAY * (2 + QUERY)
    ep = images[np.random.default_rng(6).permutation(40)[:n]]
    perms = np.stack([np.random.default_rng(20 + s).permutation(WAY * shot)
                      for s in range(2)]).astype(np.int32)
    sfc_kw = {"steps": 2, "lr": 0.1, "batch_size": 4}
    j_loss, j_grads = _j_episode_grads(variables, ep, "sinkhorn_detached", "fcn", None, shot,
                                       {**sfc_kw, "perms": jnp.asarray(perms)})
    head, fn = _t_episode(variables, "sinkhorn_detached", "fcn", shot, sfc_kw)
    seen = []
    orig = tt.sfc_refine
    tt.sfc_refine = lambda *a, **k: seen.append(orig(*a, **k)) or seen[-1]
    try:
        logits = fn(torch.from_numpy(ep)[None], [0],
                    perms=torch.from_numpy(perms.astype(np.int64))[None])[0]
    finally:
        tt.sfc_refine = orig
    assert len(seen) == 1 and not seen[0].requires_grad and seen[0].grad_fn is None
    loss = F.cross_entropy(logits.float(), torch.arange(WAY).repeat(QUERY))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=0, atol=1e-4)
    want = from_flax({"params": numpy_tree(j_grads)})
    for k, p in head.named_parameters():
        scale = want[k].abs().max().item()
        assert (p.grad - want[k]).abs().max().item() <= 1e-4 * scale + 1e-6, k


# --- the task batch -------------------------------------------------------------------


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(1.0))
        self.unused = torch.nn.Parameter(torch.tensor(2.0))


@pytest.mark.parametrize("nan_eps,n_keep", [((), 3), ((1,), 1), ((2,), 0), ((0, 1), 1), ((0,), 2)])
def test_task_batch_nan_rule_matches_jax(nan_eps, n_keep):
    """``bs`` 3 with a NaN planted in some episodes' gradient of one tensor:
    the update is the sum over the episodes after the last such one, over
    ``bs``; equal for both values of ``grad_accum``, equal to JAX's
    ``make_emd_epoch_fn`` in both of its modes, equal to the closed form."""
    way, query, epb, lr = 2, 2, 3, 0.5
    base_np = np.tile(np.arange(way, dtype=np.float32)[None], (way * query, 1))
    images = np.zeros((2, 4, 4, 3), np.uint8)
    images[0] = 255  # image 0 marks a NaN episode
    ep_len = way * (1 + query)
    idx = np.asarray([[0 if e in nan_eps else 1] * ep_len for e in range(epb)], np.int32)[None]

    j_labels, j_base = jnp.tile(jnp.arange(way), query), jnp.asarray(base_np)

    def j_episode_fn(variables, imgs, key):
        bad = jnp.where(imgs[0, 0, 0, 0].astype(jnp.float32) == 255.0, jnp.nan, 1.0)
        return variables["params"]["w"] * bad * j_base

    g1 = float(jax.grad(lambda p: optax.softmax_cross_entropy_with_integer_labels(
        p * j_base, j_labels).mean())(jnp.float32(1.0)))
    want = 1.0 - lr * (n_keep * g1 / epb)

    j_got = {}
    for accum in (False, True):
        tx = optax.sgd(lr)
        state = JTrainState.create({"params": {"w": jnp.float32(1.0)}}, tx)
        ep = jt.make_emd_epoch_fn(j_episode_fn, tx, j_labels, epb, grad_accum=accum)
        state, _ = ep(state, jnp.asarray(images), jnp.asarray(idx), jax.random.key(0))
        j_got[accum] = float(state.params["w"])

    t_labels, t_base = torch.arange(way).repeat(query), torch.from_numpy(base_np)
    for accum in (False, True):
        toy = _Toy()

        def t_episode_fn(imgs, episode_ids, key=None):
            bad = torch.where(imgs[0, 0, 0, 0, 0].float() == 255.0, float("nan"), 1.0)
            return (toy.w * bad * t_base)[None]

        state = TrainState(toy, tt.ScheduledOptimizer(torch.optim.SGD(toy.parameters(), lr=lr),
                                                      zero_nan=True))
        ep = tt.make_emd_epoch_fn(t_episode_fn, t_labels, epb, grad_accum=accum)
        ms = ep(state, torch.from_numpy(images), torch.from_numpy(idx.astype(np.int64)), (0, 1))
        got = toy.w.item()
        assert got == pytest.approx(want, rel=1e-5, abs=1e-7), (nan_eps, accum)
        assert got == pytest.approx(j_got[accum], rel=1e-6, abs=1e-7), (nan_eps, accum)
        assert toy.unused.item() == 2.0 and toy.unused.grad is not None  # a zero gradient
        assert state.step == 1 and ms["loss"].shape == (1,)
        assert bool(torch.isnan(ms["loss"][0])) == bool(nan_eps)


def test_trajectory_matches_jax(setup):
    """fcn (no random draw is left), ``bs`` 2, two epochs of two steps across
    a StepLR milestone, ``build_sund_optimizer`` on both sides: per-step loss
    and accuracy within 1e-4, final parameters within 2e-5, BN statistics
    untouched."""
    variables, images = setup
    cfg = {"lr": 0.02, "step_size": 1, "gamma": 0.5, "max_epoch": 2}
    epb, steps = 2, 2
    n = WAY * (SHOT + QUERY)
    idx = np.random.default_rng(8).integers(0, 40, (2, steps, epb, n)).astype(np.int32)

    jhead = JDeepEMD(encoder=JVisformer(**TINY), solver_iters=20)
    tx = jt.build_sund_optimizer(JConfig(cfg), steps)
    j_fn = jt.make_emd_episode_fn(jhead, WAY, SHOT, QUERY,
                                  jt.make_patch_fn("fcn", [2, 3], 9, 2.0, 32, True),
                                  MEAN, STD, sfc=False, train=True)
    j_epoch = jt.make_emd_epoch_fn(j_fn, tx, jnp.tile(jnp.arange(WAY), QUERY), epb)
    jstate = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    j_ms = []
    for e in range(2):
        jstate, ms = j_epoch(jstate, jnp.asarray(images), jnp.asarray(idx[e]), jax.random.key(e))
        j_ms.append({k: np.asarray(v) for k, v in ms.items()})

    head, fn = _t_episode(variables, "sinkhorn_detached", "fcn")
    state = TrainState(head, tt.build_sund_optimizer(Config(cfg), head.parameters()))
    epoch = tt.make_emd_epoch_fn(fn, torch.arange(WAY).repeat(QUERY), epb)
    for e in range(2):
        assert state.optimizer.set_epoch(e) == pytest.approx(0.02 * 0.5 ** e)
        ms = epoch(state, torch.from_numpy(images), torch.from_numpy(idx[e].astype(np.int64)),
                   (0, e + 1))
        np.testing.assert_allclose(ms["loss"].numpy(), j_ms[e]["loss"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(ms["acc"].numpy(), j_ms[e]["acc"], rtol=0, atol=1e-4)
    assert state.step == 4
    got, start = state.variables, from_flax(variables)
    for k, v in from_flax({"params": numpy_tree(jstate.params)}).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=2e-5, err_msg=k)
        assert not torch.equal(got[k], start[k]), k
    for k in from_flax({"batch_stats": variables["batch_stats"]}):
        assert torch.equal(got[k], start[k]), k


def test_pyramid_step_matches_jax(setup, interpret_pallas):
    """One ``meta_tune_emd`` step with the reference's ``feature_pyramid:
    [2, 3]`` (fcn, ``solver: sinkhorn_pallas``, ``bs`` 2) against JAX's, the
    JAX kernel in interpret mode: loss within 1e-4, parameters within 2e-5,
    every parameter moved, BN statistics untouched."""
    variables, images = setup
    cfg = {"lr": 0.02, "step_size": 1, "gamma": 0.5, "max_epoch": 1}
    epb = 2
    n = WAY * (SHOT + QUERY)
    idx = np.random.default_rng(9).integers(0, 40, (1, epb, n)).astype(np.int32)
    kw = dict(solver="sinkhorn_pallas", solver_iters=20, feature_pyramid=(2, 3))

    jhead = JDeepEMD(encoder=JVisformer(**TINY), **kw)
    tx = jt.build_sund_optimizer(JConfig(cfg), 1)
    j_fn = jt.make_emd_episode_fn(jhead, WAY, SHOT, QUERY,
                                  jt.make_patch_fn("fcn", [2, 3], 9, 2.0, 32, True),
                                  MEAN, STD, sfc=False, train=True)
    j_epoch = jt.make_emd_epoch_fn(j_fn, tx, jnp.tile(jnp.arange(WAY), QUERY), epb)
    jstate = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jstate, j_ms = j_epoch(jstate, jnp.asarray(images), jnp.asarray(idx), jax.random.key(0))

    head = load_flax(TDeepEMD(TVisformer(**TINY, device="cpu"), **kw), variables)
    fn = tt.make_emd_episode_fn(head, WAY, SHOT, QUERY,
                                tt.make_patch_fn("fcn", [2, 3], 2.0, 32, train=True),
                                MEAN, STD, sfc=False, train=True)
    state = TrainState(head, tt.build_sund_optimizer(Config(cfg), head.parameters()))
    epoch = tt.make_emd_epoch_fn(fn, torch.arange(WAY).repeat(QUERY), epb)
    state.optimizer.set_epoch(0)
    launches = tks.sinkhorn_pallas.launches
    ms = epoch(state, torch.from_numpy(images), torch.from_numpy(idx.astype(np.int64)), (0, 1))
    assert tks.sinkhorn_pallas.launches == launches  # CPU tensors: the plain version
    np.testing.assert_allclose(ms["loss"].numpy(), np.asarray(j_ms["loss"]), rtol=0, atol=1e-4)
    got, start = state.variables, from_flax(variables)
    for k, v in from_flax({"params": numpy_tree(jstate.params)}).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=2e-5, err_msg=k)
        assert not torch.equal(got[k], start[k]), k
    for k in from_flax({"batch_stats": variables["batch_stats"]}):
        assert torch.equal(got[k], start[k]), k


def test_validate_episode_mesh_messages():
    cases = [({"data": 4}, True, 4), ({"model": 4}, False, 4), ({"data": 4}, False, 6)]
    for mesh, accum, bs in cases:
        with pytest.raises(ValueError) as want:
            jt.validate_episode_mesh(mesh, accum, bs)
        with pytest.raises(ValueError) as got:
            tt.validate_episode_mesh(mesh, accum, bs)
        assert str(got.value) == str(want.value)
    tt.validate_episode_mesh({"data": 2}, False, 4)
    with pytest.raises(ValueError, match="must divide"):
        tt.make_emd_epoch_fn(None, None, 3, mesh=SimpleNamespace(shape={"data": 2}))
    assert callable(tt.make_emd_epoch_fn(None, None, 4, mesh=make_mesh({"data": 1}, "cpu")))


# --- the CLI ---------------------------------------------------------------------------

CLI_CONFIG = """
train_dataset: synthetic
train_dataset_args: {n_classes: 6, n_per_class: 8, image_size: 32, seed: 2}
val_dataset: synthetic
val_dataset_args: {n_classes: 5, n_per_class: 6, image_size: 32, seed: 3}
model_args:
  encoder: visformer_micro_80
  encoder_args: {img_size: 32, init_channels: 8, embed_dim: 48, depth: [1, 1, 1],
                 drop_path_rate: 0.2, use_pallas_attn: true}
deepemd: %s
image_size: 32
num_patch: 3
solver: sinkhorn_pallas
solver_iters: 10
way: 3
shot: 1
query: 2
bs: 2
train_batches: 2
max_epoch: %d
lr: 5.e-4
step_size: 1
gamma: 0.5
val_episode: 3
test_episode: 4
%s
"""


@pytest.mark.parametrize("mode", ["grid", "sampling"])
def test_cli_on_cpu_writes_results_and_resumes(tmp_path, capsys, mode):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(CLI_CONFIG % (mode, 2, "grad_accum: true\nremat: true"))
    argv = ["--config", str(cfg), "--save-root", str(tmp_path / "save"), "--name", "run",
            "--device", "cpu"]
    state = tt.main(*parse_args("test", argv))
    out = capsys.readouterr().out
    assert "epoch 1 lr=0.0005" in out and "epoch 2 lr=0.00025" in out
    assert "final test 3w1s (4 episodes)" in out and state.step == 4
    run = tmp_path / "save" / "run"
    for name in ("epoch-last", "max-va", "resume"):
        assert (run / name / "arrays.pt").is_file(), name
    lines = (run / "results.txt").read_text().splitlines()
    assert len(lines) == 2 and lines[0].startswith("Val Best Epoch ")
    assert lines[1].startswith("Test Acc ")
    if mode == "sampling":
        return
    # resume: nothing left at 2 epochs (the final test appends again), epoch 3 at 3
    cfg.write_text(CLI_CONFIG % (mode, 2, "resume: true"))
    tt.main(*parse_args("test", argv))
    out = capsys.readouterr().out
    assert "resumed full train state from epoch 2" in out and "nothing left to do" in out
    assert len((run / "results.txt").read_text().splitlines()) == 4
    cfg.write_text(CLI_CONFIG % (mode, 3, "resume: true"))
    resumed = tt.main(*parse_args("test", argv))
    out = capsys.readouterr().out
    assert "epoch 3 lr=0.000125" in out and "epoch 2 " not in out and resumed.step == 6


def test_cli_mesh_fails_with_the_jax_words_and_needs_a_card(tmp_path, monkeypatch):
    from fewshot_vit_tpu_torch.core.config import load_config

    cfg, ok = tmp_path / "c.yaml", tmp_path / "ok.yaml"
    ok.write_text(CLI_CONFIG % ("grid", 1, ""))
    _, args = parse_args("test", ["--config", str(ok), "--device", "cpu"])
    cfg.write_text(CLI_CONFIG % ("grid", 1, "mesh: {data: 4}"))
    with pytest.raises(ValueError, match="must divide evenly over the mesh data"):
        tt.main(load_config(str(cfg)), args)  # bs 2 over data 4
    cfg.write_text(CLI_CONFIG % ("grid", 1, "mesh: {data: 2}"))
    with pytest.raises(ValueError, match=r"mesh \{'data': 2\} needs 2 devices, have 1"):
        tt.main(load_config(str(cfg)), args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_, cuda_args = parse_args("test", ["--config", str(ok)])
    assert cuda_args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.main(cfg_, cuda_args)
