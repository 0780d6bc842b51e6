"""Port parity, SUN supervision and the classification heads:
``generate_soft_label`` bit-identical to the JAX package's (ties included),
``soft_target_cross_entropy`` within 1e-6 relative (the loss here is about
25, where one fp32 ulp is 1.9e-6), and the ``TokenLabel`` (teacher and
student routes) and ``Classifier`` (linear and nn) forwards within 1e-5,
relative and absolute (logits up to about 15: XLA:CPU and torch sum the
fp32 convolutions in other orders), from JAX weights carried across with
``load_flax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.heads import classifier as jc
from fewshot_vit_tpu.heads.token_label import TokenLabel as JTokenLabel
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.ops.token_label import generate_soft_label as j_soft
from fewshot_vit_tpu.ops.token_label import soft_target_cross_entropy as j_ste
from fewshot_vit_tpu_torch.checkpoint import from_flax, load_flax
from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.heads.classifier import make_classifier
from fewshot_vit_tpu_torch.heads.token_label import TokenLabel
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.ops.token_label import generate_soft_label, soft_target_cross_entropy

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
TINY = dict(img_size=32, init_channels=8, embed_dim=48, depth=(1, 1, 1), num_heads=6)
FWD_TOL = 1e-5


def _logits(kind, seed, shape):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(0.0, 2.0, shape).astype(np.float32)
    # integer-valued logits in a narrow range: ties everywhere, in the
    # saliency (max over classes) and within each token's top-k
    return rng.integers(-2, 3, shape).astype(np.float32)


@pytest.mark.parametrize("kind,k,bg,shape", [
    ("normal", 5, 10, (4, 25, 64)),
    ("ties", 5, 10, (4, 25, 64)),
    ("ties", 3, 0, (3, 16, 7)),
    ("ties", 7, 15, (2, 16, 7)),
    ("normal", 1, 24, (2, 25, 12)),
])
def test_generate_soft_label_bit_identical(kind, k, bg, shape):
    x = _logits(kind, sum(shape) + k, shape)
    want = np.asarray(j_soft(jnp.asarray(x), smoothing=0.1, k=k, bg_tokens=bg))
    got = generate_soft_label(torch.from_numpy(x), smoothing=0.1, k=k, bg_tokens=bg)
    assert got.dtype == torch.float32 and got.shape == shape[:2] + (shape[2] + 1,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ties_go_to_the_lower_index():
    """All-equal logits: the first T - bg tokens are foreground, and the
    first k classes are each token's top k."""
    got = generate_soft_label(torch.zeros(1, 6, 5), smoothing=0.1, k=2, bg_tokens=2)
    off, on = 0.1 / 5, 1.0 - 0.1 + 0.1 / 5
    assert (got[0, :4, :2] > off).all() and (got[0, :4, 2:] == np.float32(off)).all()
    assert (got[0, 4:, 5] == np.float32(on)).all() and (got[0, 4:, :5] == np.float32(off)).all()


def test_background_tokens_get_the_extra_class():
    """The least salient tokens are labelled class C (the JAX package's fix of
    the reference, which labels them class 1)."""
    x = torch.randn(2, 9, 4, generator=torch.Generator().manual_seed(0))
    x[:, 3] -= 100.0  # token 3 is the least salient
    soft = generate_soft_label(x, k=1, bg_tokens=1)
    assert torch.equal(soft[:, 3].argmax(-1), torch.tensor([4, 4]))
    assert (soft[:, [0, 1, 2, 4, 5, 6, 7, 8], 4] < 0.5).all()
    for bad in ({"k": 0}, {"k": 5}, {"bg_tokens": 9}, {"bg_tokens": -1}):
        with pytest.raises(ValueError):
            generate_soft_label(x, **bad)


def test_soft_target_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (4, 25, 65)).astype(np.float32)
    target = np.array(j_soft(jnp.asarray(rng.normal(size=(4, 25, 64)).astype(np.float32))))
    want = float(j_ste(jnp.asarray(logits), jnp.asarray(target)))
    got = soft_target_cross_entropy(torch.from_numpy(logits), torch.from_numpy(target))
    assert got.dim() == 0 and abs(got.item() - want) <= 1e-6 * abs(want)


@pytest.fixture(scope="module")
def token_label_pair():
    """A narrow Visformer at img 80 (stage 2 has T = 100, so the fused
    attention's dispatch rule is reached), JAX weights with non-trivial BN."""
    jmodel = JTokenLabel(encoder=JVisformer(**SMALL_VISFORMER), n_classes=7)
    x = np.random.default_rng(2).normal(size=(3, 80, 80, 3)).astype(np.float32)
    variables = randomize_bn(numpy_tree(jmodel.init(jax.random.key(0), jnp.asarray(x))))
    return jmodel, variables, x


@pytest.mark.parametrize("is_teacher", [True, False], ids=["teacher", "student"])
@pytest.mark.parametrize("fused", [False, True], ids=["einsum", "fused-attn"])
def test_token_label_forward_matches_jax(token_label_pair, is_teacher, fused):
    """Both routes; the port's teacher also with ``use_pallas_attn`` (on the
    CPU the fused attention computes its plain version)."""
    jmodel, variables, x = token_label_pair
    want = jmodel.apply(variables, jnp.asarray(x), train=False, is_teacher=is_teacher)
    model = load_flax(TokenLabel(TVisformer(**SMALL_VISFORMER, use_pallas_attn=fused,
                                            device="cpu"), 7), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x), is_teacher=is_teacher)
    assert got[0].shape == (3, 5, 5, 7 if is_teacher else 8) and got[1].shape == (3, 7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("classifier,cargs", [
    ("linear-classifier", {}),
    ("nn-classifier", {}),
    ("nn-classifier", {"metric": "sqr", "temp": 0.5}),
])
def test_classifier_forward_matches_jax(classifier, cargs):
    jhead = (jc.LinearClassifier(5, name="classifier") if classifier == "linear-classifier"
             else jc.NNClassifier(5, 96, name="classifier", **cargs))
    jmodel = jc.Classifier(encoder=JVisformer(**TINY), classifier=jhead)
    x = np.random.default_rng(3).normal(size=(4, 32, 32, 3)).astype(np.float32)
    variables = randomize_bn(numpy_tree(jmodel.init(jax.random.key(1), jnp.asarray(x))))
    if classifier == "nn-classifier" and not cargs:
        variables["params"]["classifier"]["temp"] = np.float32(7.5)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    model = make_classifier("visformer_micro_80", encoder_args=TINY, classifier=classifier,
                            classifier_args={"n_classes": 5, **cargs}, device="cpu")
    keys = set(model.state_dict())
    assert keys == set(from_flax(variables))  # every leaf has one place, and back
    load_flax(model, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


def test_heads_are_registered_and_default_to_the_card(monkeypatch):
    model = models.make("token-label", encoder="visformer_micro_80", encoder_args=TINY,
                        classifier_args={"n_classes": 4}, device="cpu")
    assert isinstance(model, TokenLabel) and not model.training
    assert model.classifier_local.linear.weight.shape == (5, 96)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, kw in (("token-label", {"classifier_args": {"n_classes": 4}}),
                     ("classifier", {"classifier_args": {"n_classes": 4}})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.make(name, encoder="visformer_micro_80", **kw)
