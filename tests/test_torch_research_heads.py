"""Port parity of the research heads: ``token-label-ep``, ``-ep-rw``,
``-ep-cr``, ``-v2`` and ``meta-token``, ``-v2``, ``-v3``, each against its
JAX twin in fp32 on the same numpy images, 1-shot and 5-shot, every output
within 1e-5 (the head-forward rule: XLA:CPU and torch sum the fp32
convolutions in other orders), from JAX weights carried across with
``load_flax``; the four metric functions they need; the top-k selection of
``sampling_keep`` / ``sampling_pool`` against ``jax.lax.top_k``, ties
included; the refusal of the meta-tune loop, with JAX's message; and the
port's registry against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fewshot_vit_tpu.heads  # noqa: F401  (registers the JAX heads)
import fewshot_vit_tpu.models  # noqa: F401
from fewshot_vit_tpu.core.registry import models as jmodels
from fewshot_vit_tpu.heads import meta_token as jmt
from fewshot_vit_tpu.heads import token_label as jtl
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.ops import metric as jmetric
from fewshot_vit_tpu.train.meta_tune import check_standard_episodic as j_check
import fewshot_vit_tpu_torch.heads  # noqa: F401  (registers the port's heads)
from fewshot_vit_tpu_torch.checkpoint import load_flax
from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.heads import meta_token as tmt
from fewshot_vit_tpu_torch.ops import metric as tmetric
from fewshot_vit_tpu_torch.train.meta_tune import check_standard_episodic

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
FWD_TOL = 1e-5
WAY, QUERY, E = 3, 2, 2
EPISODIC = ("token-label-ep", "token-label-ep-rw", "token-label-ep-cr")
META_TOKEN = ("meta-token", "meta-token-v2", "meta-token-v3")
RESEARCH = EPISODIC + ("token-label-v2",) + META_TOKEN
# ``cls_logits_reweight`` (output 3 of token-label-ep-rw) passes sigmoid
# gates of dot products up to about 90 and a mean over the gated tokens:
# from the same fp32 features, XLA:CPU's fp32 lands 4.6e-5 from a float64
# evaluation and the port 6.7e-6 (measured at seed 18, 1-shot). So that
# output is held to JAX at 1e-4 and to float64 at 1e-5
# (test_reweight_cls_logits_match_float64); every other output to JAX at 1e-5.
OUT_TOL = {("token-label-ep-rw", 3): 1e-4}


def _jax_head(name):
    enc = JVisformer(**SMALL_VISFORMER)
    return {
        "token-label-ep": lambda: jtl.TokenLabelEpisodic(encoder=enc),
        "token-label-ep-rw": lambda: jtl.TokenLabelEpisodicReweight(encoder=enc),
        "token-label-ep-cr": lambda: jtl.TokenLabelEpisodicChannelAttn(encoder=enc),
        "token-label-v2": lambda: jtl.TokenLabelV2(encoder=enc, n_classes=7, dim=32),
        "meta-token": lambda: jmt.MetaToken(encoder=enc),
        "meta-token-v2": lambda: jmt.MetaTokenV2(encoder=enc),
        "meta-token-v3": lambda: jmt.MetaTokenV3(encoder=enc, num_heads=2),
    }[name]()


def _port_head(name, use_pallas_attn=True):
    kw = {"token-label-v2": {"classifier_args": {"n_classes": 7}, "dim": 32},
          "meta-token-v3": {"num_heads": 2}}.get(name, {})
    return models.make(name, encoder="visformer_micro_80",
                       encoder_args={**SMALL_VISFORMER, "use_pallas_attn": use_pallas_attn},
                       device="cpu", **kw)


def _inputs(name, shot, seed):
    rng = np.random.default_rng(seed)
    img = lambda *s: rng.normal(size=s + (80, 80, 3)).astype(np.float32)
    if name == "token-label-v2":
        return (img(3),)
    query = (E, WAY, QUERY) if name in META_TOKEN else (E, WAY * QUERY)
    return img(E, WAY, shot), img(*query)


@pytest.mark.parametrize("shot", [1, 5])
@pytest.mark.parametrize("name", RESEARCH)
def test_research_head_matches_jax(name, shot):
    """Every output of the head, fp32, from the same flax variables; the
    port's encoder with ``use_pallas_attn`` (its plain version on the CPU)."""
    x = _inputs(name, shot, seed=len(name) + shot)
    jhead = _jax_head(name)
    variables = randomize_bn(numpy_tree(jhead.init(jax.random.key(shot),
                                                   *map(jnp.asarray, x))))
    if "temp" in variables["params"]:
        variables["params"]["temp"] = np.float32(7.5)
    want = jhead.apply(variables, *map(jnp.asarray, x), train=False)
    head = load_flax(_port_head(name), variables)
    with torch.no_grad():
        got = head(*map(torch.from_numpy, x))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        tol = OUT_TOL.get((name, i), FWD_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("shot", [1, 5])
def test_reweight_cls_logits_match_float64(shot):
    """The reweighted cls branch of ``token-label-ep-rw`` against a float64
    numpy evaluation of the same math from the port's own encoder features
    and head weights: within 1e-5."""
    from fewshot_vit_tpu_torch.heads.token_label import _encode_episode

    name = "token-label-ep-rw"
    x = [torch.from_numpy(a) for a in _inputs(name, shot, seed=len(name) + shot)]
    head = _port_head(name)
    with torch.no_grad():
        got = head(*x)[3].numpy()
        fs, fq, _, _ = (t.double().numpy() for t in _encode_episode(head.encoder, *x))
    p = {k: v.double().numpy() for k, v in head.state_dict().items()}

    def mlp(m, z):
        h = np.maximum(z @ p[f"{m}.fc1.weight"].T + p[f"{m}.fc1.bias"], 0.0)
        return h @ p[f"{m}.fc2.weight"].T + p[f"{m}.fc2.bias"]

    sig = lambda z: 1.0 / (1.0 + np.exp(-z))
    norm = lambda a: a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    w_task = mlp("intra_task_learner", fs.mean(axis=(1, 2, 3)))
    w_class = sig(mlp("intra_class_learner", fs.mean(axis=(2, 3))))
    fq_rw = fq[:, :, None] * w_class[:, None, :, None]
    fs_rw = fs * w_class[:, :, None, None]
    fq_rw = fq_rw * sig(np.einsum("eqntc,ec->eqnt", fq_rw, w_task))[..., None]
    fs_rw = fs_rw * sig(np.einsum("enktc,ec->enkt", fs_rw, w_task))[..., None]
    want = np.einsum("eqnc,enc->eqn", norm(fq_rw.mean(axis=3)), norm(fs_rw.mean(axis=(2, 3))))
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_output_shapes_follow_the_jax_contracts():
    """Meta-token: (E, way*query, way*shot) and (E, way*query, way);
    the episodic token-label heads: (E, Q, way)."""
    shot = 2
    with torch.no_grad():
        logits, cls = _port_head("meta-token")(*map(torch.from_numpy, _inputs("meta-token",
                                                                                shot, 0)))
        assert logits.shape == (E, WAY * QUERY, WAY * shot) and cls.shape == (E, WAY * QUERY, WAY)
        outs = _port_head("token-label-ep-rw")(*map(torch.from_numpy,
                                                    _inputs("token-label-ep-rw", shot, 1)))
        assert len(outs) == 4 and all(o.shape == (E, WAY * QUERY, WAY) for o in outs)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("fn", ["compute_logits_kshot", "compute_logits_local_kshot"])
def test_kshot_logits_match_jax(fn):
    feat, proto = (_rand(1, 2, 6, 4, 3, 16), _rand(2, 2, 1, 4, 3, 16)) \
        if fn == "compute_logits_local_kshot" else (_rand(1, 2, 6, 4, 16), _rand(2, 2, 1, 4, 16))
    want = getattr(jmetric, fn)(jnp.asarray(feat), jnp.asarray(proto), 7.5)
    got = getattr(tmetric, fn)(torch.from_numpy(feat), torch.from_numpy(proto), 7.5)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_compute_acc_kshots_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.integers(-2, 3, (40, 15)).astype(np.float32)  # ties: the first maximum
    label = rng.integers(0, 3, 40)
    want = float(jmetric.compute_acc_kshots(jnp.asarray(logits), jnp.asarray(label), shot=5))
    got = tmetric.compute_acc_kshots(torch.from_numpy(logits), torch.from_numpy(label), shot=5)
    assert got.dim() == 0 and got.item() == want


def test_softmax_kl_loss_matches_jax_and_detaches_the_target():
    inp, tgt = _rand(4, 6, 5, 7), _rand(5, 6, 5, 7)
    mask = (np.random.default_rng(6).random((6, 5, 7)) < 0.6).astype(np.float32)
    want, (g_in, g_tgt) = jax.value_and_grad(jmetric.softmax_kl_loss, argnums=(0, 1))(
        jnp.asarray(inp), jnp.asarray(tgt), jnp.asarray(mask))
    ti = torch.from_numpy(inp).requires_grad_(True)
    tt = torch.from_numpy(tgt).requires_grad_(True)
    got = tmetric.softmax_kl_loss(ti, tt, torch.from_numpy(mask))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(g_in), rtol=1e-5, atol=1e-7)
    assert not np.asarray(g_tgt).any() and tt.grad is None  # stop_gradient / detach


@pytest.mark.parametrize("scores", ["random", "tied"])
@pytest.mark.parametrize("fn", ["sampling_pool", "sampling_keep"])
def test_sampling_picks_jax_top_k(fn, scores):
    """The same patches as ``jax.lax.top_k``: with a zero token every patch
    scores the same and the lower indices win."""
    token = np.zeros((2, 3, 2, 16), np.float32) if scores == "tied" else _rand(7, 2, 3, 2, 16)
    feature = _rand(8, 2, 3, 2, 25, 16)
    want = getattr(jmt, fn)(jnp.asarray(token), jnp.asarray(feature))
    got = getattr(tmt, fn)(torch.from_numpy(token), torch.from_numpy(feature))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_top_k_ties_take_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = tmt._top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 4]]
    assert vals.tolist() == np.asarray(jv).tolist()
    with pytest.raises(ValueError, match="0 patches"):
        tmt.sampling_pool(torch.zeros(1, 2, 1, 8), torch.zeros(1, 2, 1, 4, 8), rate=0.1)


def test_token_qkv_matches_jax():
    feat_query, support = _rand(9, 2, 3, 2, 25, 16), _rand(10, 2, 3, 4, 16)
    for w, g in zip(jmt.token_qkv(jnp.asarray(feat_query), jnp.asarray(support), 4),
                    tmt.token_qkv(torch.from_numpy(feat_query), torch.from_numpy(support), 4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", RESEARCH)
def test_meta_tune_loop_refuses_with_jax_message(name):
    tiny = dict(SMALL_VISFORMER, img_size=32, init_channels=8, embed_dim=48)
    kw = {"classifier_args": {"n_classes": 4}} if name == "token-label-v2" else {}
    head = models.make(name, encoder="visformer_micro_80", encoder_args=tiny, device="cpu", **kw)
    with pytest.raises(ValueError) as got:
        check_standard_episodic(head, name)
    with pytest.raises(ValueError) as want:
        j_check(_jax_head(name), name)
    assert str(got.value) == str(want.value) and "episodic" in str(got.value)


def test_registry_holds_every_jax_name():
    assert set(jmodels.names()) <= set(models._ctors)
    assert set(RESEARCH) <= set(models._ctors)


def test_meta_token_refuses_other_metrics_and_defaults_to_the_card(monkeypatch):
    with pytest.raises(ValueError, match="method='cos' only"):
        _port_head("meta-token").__class__(torch.nn.Identity(), method="sqr")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in RESEARCH:
        kw = {"classifier_args": {"n_classes": 4}} if name == "token-label-v2" else {}
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.make(name, encoder="visformer_micro_80", **kw)
