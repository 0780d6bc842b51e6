"""Port parity, the int8 eval path: ``models/quant.py`` against
``fewshot_vit_tpu/models/quant.py``.

The int8 products are integer sums (``torch._int_mm`` here, ``lax``
int32 dots and convs in JAX), so a layer given the same int8 weights and the
same input is held BIT-identical, its int32 accumulation first. A whole
encoder is not: its float ops (GELU, softmax, the residual adds) differ from
XLA:CPU's by ulps, and where a value sits on a rounding boundary of the next
layer's activation grid one int8 step flips, which moves that output by one
step of that layer's scale; the tolerance below is measured."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.core.registry import models as j_models
from fewshot_vit_tpu.models import quant as jq
from fewshot_vit_tpu.models.fold import fold_visformer as j_fold
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu_torch.checkpoint import from_flax, load_flax
from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.data.datasets import synthetic
from fewshot_vit_tpu_torch.eval.episodic import evaluate
from fewshot_vit_tpu_torch.heads import meta_baseline as _heads  # noqa: F401
from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline
from fewshot_vit_tpu_torch.models import quant as tq
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
# The SMALL int8 encoder from JAX's quantized tree, as a share of the
# output's max |value| (dense map, pooled embedding). Static scales: measured
# 8.5e-8 and 1.4e-7 (XLA:CPU's and torch's float ops an ulp apart, no int8
# step flipped). Dynamic scales: measured 2.25e-2 and 3.3e-3. There each
# layer's scale is max|x| / 127 of its own input, so an ulp flip of one int8
# value at the element holding a tensor's max moves that scale by up to
# 1/254 and rescales the whole next layer, whose rounding then flips in many
# places: one flip spreads to every later layer. The layers themselves are
# bit-identical (test_quant_layers_bit_identical).
EMB_TOL = {"static": (1e-6, 1e-6), "dynamic": (3e-2, 5e-3)}
# The calibration forward runs the dynamic model, so the same spreading
# reaches the calibrated scales: 16 of the 17 layers of the SMALL encoder are
# within 3.5e-7 of JAX's on this seed, the last one, whose input follows an
# int8 flip in the layer before it, 5.5e-3 off (a different max|x|).
FLIPPED_SCALES = {"stage3.0.mlp.conv3.ascale": 1e-2}


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_dynamic_quant_bit_identical(dtype):
    x = np.random.default_rng(0).normal(0, 3.0, (64, 33)).astype(np.float32)
    x[0, 0] = 0.0
    jx = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    tx = torch.from_numpy(x).to(torch.bfloat16) if dtype == "bfloat16" else torch.from_numpy(x)
    jqv, js = jq.dynamic_quant(jx)
    tqv, ts = tq.dynamic_quant(tx)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32 and ts.dim() == 0
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    assert ts.item() == float(js)
    assert tqv[0, 0] == 0  # symmetric: conv zero padding stays exact


def test_quantize_kernel_bit_identical():
    k = np.random.default_rng(1).normal(0, 1, (3, 3, 8, 16)).astype(np.float32)
    k[..., 3] *= 50.0  # one hot channel must not crush the others' grid
    jk, jws = jq.quantize_kernel(k)  # HWIO
    tk, tws = tq.quantize_kernel(torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()))  # OIHW
    np.testing.assert_array_equal(tk.numpy(), np.transpose(jk, (3, 2, 0, 1)))
    np.testing.assert_array_equal(tws.numpy(), jws)


# (kind, kernel, stride, padding, groups, cin, cout): the encoder's int8 layers
LAYERS = [("dense", 1, 1, 0, 1, 32, 24), ("dense", 1, 1, 0, 1, 252, 756),
          ("conv", 3, 1, 1, 1, 16, 24), ("conv", 3, 2, 1, 1, 3, 16),
          ("conv", 3, 1, 1, 8, 64, 64), ("conv", 2, 2, 0, 1, 32, 48)]


def _jax_layer(kind, k, st, pad, g, cout, bias, static):
    if kind == "dense":
        return jq.QuantDense(cout, use_bias=bias, static_act=static)
    return jq.QuantConv(cout, (k, k), strides=(st, st), padding=pad if pad else "VALID",
                        feature_group_count=g, use_bias=bias, static_act=static)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("layer", LAYERS, ids=lambda t: f"{t[0]}{t[1]}s{t[2]}g{t[4]}c{t[6]}")
def test_quant_layers_bit_identical(layer, bias, static, monkeypatch):
    kind, k, st, pad, g, cin, cout = layer
    rng = np.random.default_rng(cin + cout + 2 * bias + static)
    x = rng.normal(0, 2, (2, 9, 9, cin)).astype(np.float32)
    kern = rng.normal(0, 1, (cin, cout) if kind == "dense" else (k, k, cin // g, cout))
    qk, ws = jq.quantize_kernel(kern)
    params = {"kernel": qk, "wscale": ws}
    if bias:
        params["bias"] = rng.normal(size=cout).astype(np.float32)
    if static:
        params["ascale"] = np.float32(0.05)
    want = np.asarray(_jax_layer(kind, k, st, pad, g, cout, bias, static)
                      .apply({"params": params}, jnp.asarray(x)))
    if kind == "dense":
        mod = tq.QuantDense(cin, cout, bias, static)
    else:
        mod = tq.QuantConv(cin, cout, k, st, pad, g, bias, static)
    like = {f"l.{n}": t for n, t in mod.state_dict().items()}
    sd = from_flax({"params": {"l": params}}, like=like)  # JAX's layouts -> the port's
    mod.load_state_dict({n[len("l."):]: t for n, t in sd.items()})
    # the int32 accumulation itself, then the dequantized output
    q, s = (jq.dynamic_quant(jnp.asarray(x)) if not static
            else (jnp.clip(jnp.round(jnp.asarray(x) / 0.05), -127, 127).astype(jnp.int8), None))
    tqv = torch.from_numpy(np.array(q))
    if kind == "dense":
        j32 = jax.lax.dot_general(q, jnp.asarray(qk), (((3,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        t32 = tq.int8_matmul(tqv.reshape(-1, cin), mod.weight.flatten(1)).reshape(2, 9, 9, cout)
    else:
        dn = jax.lax.conv_dimension_numbers(q.shape, qk.shape, ("NHWC", "HWIO", "NHWC"))
        j32 = jax.lax.conv_general_dilated(
            q, jnp.asarray(qk), (st, st), [(pad, pad)] * 2 if pad else "VALID",
            dimension_numbers=dn, feature_group_count=g, preferred_element_type=jnp.int32)
        monkeypatch.setattr(tq, "_CHUNK_BYTES", 1)  # one image a chunk: chunking is exact too
        t32 = torch.cat(list(tq.conv_int32_chunks(tqv, mod.weight, st, pad, g)))
    np.testing.assert_array_equal(t32.numpy(), np.asarray(j32))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def quantized():
    """JAX's SMALL Visformer with non-trivial BN statistics, folded and
    quantized by JAX (dynamic, and static with scales calibrated by JAX's
    sown ``intermediates`` on a batch), and the calibration images."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 80, 80, 3)).astype(np.float32)
    calib = rng.normal(size=(6, 80, 80, 3)).astype(np.float32)
    jm = JVisformer(**SMALL_VISFORMER)
    variables = randomize_bn(numpy_tree(jm.init(jax.random.key(0), jnp.asarray(x))))
    folded = numpy_tree(j_fold(variables))
    qv = numpy_tree(jq.quantize_visformer(folded))
    _, state = JVisformer(**SMALL_VISFORMER, fold_bn=True, quant_int8=True).apply(
        qv, jnp.asarray(calib), mutable=["intermediates"])
    sv = numpy_tree(jq.quantize_visformer(folded))
    jq._insert_ascales(sv["params"], numpy_tree(state["intermediates"]))
    return x, calib, folded, qv, sv


@pytest.mark.parametrize("mode", [True, "static"], ids=["dynamic", "static"])
def test_small_int8_visformer_from_jax_tree(quantized, mode):
    x, _, _, qv, sv = quantized
    tree = sv if mode == "static" else qv
    want = JVisformer(**SMALL_VISFORMER, fold_bn=True, quant_int8=mode).apply(
        tree, jnp.asarray(x))
    port = load_flax(TVisformer(**SMALL_VISFORMER, fold_bn=True, quant_int8=mode, device="cpu"),
                     tree)
    assert port.stage2[0].attn.qkv.weight.dtype == torch.int8
    with torch.no_grad():
        dense, pooled = port(torch.from_numpy(x))
    tols = EMB_TOL["static" if mode == "static" else "dynamic"]
    for got, w, tol in ((dense, want[0], tols[0]), (pooled, want[1], tols[1])):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= tol * np.abs(w).max()


def test_port_quantization_equals_jax_tree(quantized):
    """The same folded weights quantized by the port give JAX's int8 tree
    exactly; the port's calibration (forward hooks) gives JAX's sown scales."""
    _, calib, folded, qv, sv = quantized
    got = tq.quantize_visformer(from_flax(folded, encoder="visformer_micro_80"))
    want = from_flax(qv, encoder="visformer_micro_80")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    dyn = TVisformer(**SMALL_VISFORMER, fold_bn=True, quant_int8=True, device="cpu")
    dyn.load_state_dict(got)
    scales = tq.calibrate(dyn, torch.from_numpy(calib))
    static = dict(got)
    tq._insert_ascales(static, scales)
    jscales = {k: v for k, v in from_flax(sv, encoder="visformer_micro_80").items()
               if k.endswith(".ascale")}
    assert sorted(k for k in static if k.endswith(".ascale")) == sorted(jscales)
    for key, v in jscales.items():
        np.testing.assert_allclose(static[key].numpy(), v.numpy(),
                                   rtol=FLIPPED_SCALES.get(key, 1e-6), err_msg=key)


def _head_with_stats(seed=0):
    head = models.make("meta-baseline", encoder="visformer_micro_80",
                       encoder_args=dict(SMALL_VISFORMER), device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in head.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.5, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.25, 4.0, generator=gen)
    return head


def test_episodic_accuracy_gate_both_modes():
    """JAX's gate (``tests/test_quant.py``): 5-way 1-shot accuracy on a
    separable synthetic split, fp32 head against the int8 head on the SAME
    episodes, dynamic and static (calibrated) scales: |d acc| < 0.08 and the
    protocol is not degenerate (acc > 0.7)."""
    ds = synthetic(n_classes=10, n_per_class=20, image_size=80, seed=0)
    head = _head_with_stats()
    kw = dict(n_episodes=16, shot=1, query=10, ep_per_batch=8, seed=7, device="cpu")
    acc_f, _, _ = evaluate(head, ds, **kw)
    assert acc_f > 0.7, acc_f
    from fewshot_vit_tpu_torch.data.transforms import normalize

    calib = normalize(torch.from_numpy(ds.images[:64]), ds.mean, ds.std)
    for calib_images, mode in ((None, True), (calib, "static")):
        qhead = tq.quantize_encoder_in_head(head, calib_images=calib_images)
        assert qhead.encoder.config["quant_int8"] == mode
        assert any(k.endswith("ascale") for k in qhead.state_dict()) == (mode == "static")
        acc_q, _, _ = evaluate(qhead, ds, **kw)
        assert abs(acc_f - acc_q) < 0.08, (mode, acc_f, acc_q)


def test_quant_requires_fold_and_refuses_other_encoders():
    with pytest.raises(ValueError, match=re.escape("quant_int8 requires fold_bn=True")):
        TVisformer(**SMALL_VISFORMER, quant_int8=True, device="cpu")
    levit = models.make("meta-baseline", encoder="levit_micro_80", device="cpu")
    with pytest.raises(NotImplementedError, match="encoder Levit has no int8 path"):
        tq.quantize_encoder_in_head(levit)  # folds, then finds no int8 path, as JAX
    conv4 = models.make("meta-baseline", encoder="convnet4", device="cpu")
    with pytest.raises(NotImplementedError, match="no BN folder"):
        tq.quantize_encoder_in_head(conv4)


def test_jax_refuses_the_same_way():
    """The messages above are JAX's (its LeViT refusal is
    ``tests/test_quant.py::test_quant_unsupported_encoder_raises``)."""
    import inspect

    assert 'f"encoder {type(enc).__name__} has no int8 path"' in inspect.getsource(
        jq.quantize_encoder_in_head)
    with pytest.raises(ValueError, match=re.escape("quant_int8 requires fold_bn=True")):
        JVisformer(**SMALL_VISFORMER, quant_int8=True).init(
            jax.random.key(0), jnp.zeros((1, 80, 80, 3)))


def test_head_clone_keeps_the_temperature():
    head = _head_with_stats()
    with torch.no_grad():
        head.temp.fill_(12.0)
    qhead = tq.quantize_encoder_in_head(head)
    assert isinstance(qhead, MetaBaseline) and qhead.temp.item() == 12.0
    assert qhead.encoder.stem.conv1.weight.dtype == torch.int8


def test_eval_cli_int8_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """``eval.run --int8`` (calibration on min(256, N) images drawn from
    ``np_rng(DEFAULT_SEED)``, static scales) prints the JAX CLI's accuracy
    line on the same ``synthetic-local`` config and reference ``.pth``."""
    import sys

    from fewshot_vit_tpu.eval import run as j_run
    from fewshot_vit_tpu.heads.meta_baseline import MetaBaseline as JMetaBaseline
    from fewshot_vit_tpu_torch.eval import run

    monkeypatch.setitem(j_models._ctors, "visformer_micro_80",
                        lambda **kw: JVisformer(**{**SMALL_VISFORMER, **kw}))
    jhead = JMetaBaseline(encoder=JVisformer(**SMALL_VISFORMER))
    variables = randomize_bn(numpy_tree(jhead.init(
        jax.random.key(1), jnp.zeros((1, 2, 1, 80, 80, 3)), jnp.zeros((1, 2, 80, 80, 3)))))
    pth = tmp_path / "max-va.pth"
    torch.save({"model": "meta-baseline", "model_args": {"encoder": "visformer_micro_80"},
                "model_sd": from_flax(variables)}, pth)
    cfg = tmp_path / "int8.yaml"
    cfg.write_text("dataset: synthetic-local\n"
                   "dataset_args: {n_classes: 6, n_per_class: 20, image_size: 80, seed: 2}\n"
                   "encoder: visformer_micro_80\n"
                   "model_args: {encoder_args: {init_channels: 16, embed_dim: 96, "
                   "depth: [1, 1, 1]}}\n"
                   f"load: {pth}\n")
    argv = ["--config", str(cfg), "--episodes", "16", "--int8"]
    monkeypatch.setattr(sys, "argv", ["run"] + argv)
    j_run.main()
    line = r"test epoch 1: acc=([0-9.]+) \+- ([0-9.]+) \(%\)"
    want = [float(v) for v in re.search(line, capsys.readouterr().out).groups()]
    accs = run.main(argv + ["--device", "cpu"])
    got = [float(v) for v in re.search(line, capsys.readouterr().out).groups()]
    # the mean accuracy as printed is equal; the half-width measured 2.41
    # against 2.30: a query or two flip between the CLIs where the last
    # layer's calibrated scale differs (FLIPPED_SCALES), which changes the
    # spread of the per-episode accuracies but not their mean here
    assert got[0] == want[0] and abs(got[1] - want[1]) <= 0.2, (got, want)
    assert accs.shape == (16,)
