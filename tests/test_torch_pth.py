"""Reference ``.pth`` ingestion: the same reference-format files go through
the JAX package's converter (which must read them back to the flax tree they
were written from) and the port's, whose state dict must equal
``from_flax`` of JAX's result tensor for tensor, with the head's logits
within 1e-5 of JAX's. Then the errors, and ``load_model`` from the port's
own checkpoint directories."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.checkpoint.io import (
    encoder_key_fn_for as j_encoder_key_fn_for,
    load_reference_head_checkpoint as j_load_head,
)
from fewshot_vit_tpu.eval.episodic import sub_variables
from fewshot_vit_tpu.heads.meta_baseline import MetaBaseline as JMetaBaseline
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.train.runner import load_encoder_from_checkpoint as j_load_encoder
from fewshot_vit_tpu_torch.checkpoint import (
    encoder_key_fn_for,
    from_flax,
    load_model,
    load_reference_encoder_checkpoint,
    load_reference_head_checkpoint,
    load_variables,
    save_variables,
    strip_prefix,
)
from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline as TMetaBaseline
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.train.runner import load_encoder_from_checkpoint

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
NAME = "visformer_micro_80"
QKV = "encoder.stage2.0.attn.qkv.weight"  # a 1x1 conv in the port, a Dense in flax


def _init(jhead, seed):
    xs0 = jnp.zeros((1, 2, 1, 80, 80, 3), jnp.float32)
    xq0 = jnp.zeros((1, 2, 80, 80, 3), jnp.float32)
    return numpy_tree(jhead.init(jax.random.key(seed), xs0, xq0))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jhead = JMetaBaseline(encoder=JVisformer(**SMALL_VISFORMER))
    variables = randomize_bn(_init(jhead, 1))
    variables["params"]["temp"] = np.asarray(7.5, np.float32)  # not the init value
    sd = from_flax(variables)
    enc_sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    tmp = tmp_path_factory.mktemp("pth")
    blob = {"model": "meta-baseline", "model_args": {"encoder": NAME}, "model_sd": sd}
    bn = [k[: -len("running_mean")] for k in sd if k.endswith("running_mean")]
    files = {
        "model_sd": blob,
        "buffers": dict(blob, model_sd={**sd, **{p + "num_batches_tracked": torch.tensor(7)
                                                 for p in bn}}),
        "linear_1x1": dict(blob, model_sd={**sd, QKV: sd[QKV][:, :, 0, 0].clone()}),
        "sund_params": {"params": {"module." + k: v for k, v in sd.items()}},
        "bare_encoder": enc_sd,
        "with_head_params": {"model": "classifier", "model_sd": {
            **{k: v for k, v in sd.items() if k.startswith("encoder.")}, "temp": sd["temp"],
            "classifier.linear.weight": torch.ones(64, 192),
            "classifier.linear.bias": torch.zeros(64)}},
    }
    paths = {}
    for name, obj in files.items():
        paths[name] = str(tmp / f"{name}.pth")
        torch.save(obj, paths[name])
    return jhead, variables, paths, tmp


def _tree_equal(a, b):
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)


def _port_head(seed=9):
    return TMetaBaseline(TVisformer(**SMALL_VISFORMER, device="cpu", seed=seed))


def _assert_state_equal(module, want):
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("name", ["model_sd", "buffers", "linear_1x1", "sund_params"])
def test_head_file_loads_as_jax_reads_it(setup, name):
    jhead, variables, paths, _ = setup
    converted = numpy_tree(j_load_head(paths[name], jhead, _init(jhead, 4),
                                       j_encoder_key_fn_for(NAME)))
    _tree_equal(converted, variables)  # the file is in the format JAX reads
    thead = load_reference_head_checkpoint(paths[name], _port_head(), encoder_key_fn_for(NAME))
    _assert_state_equal(thead, from_flax(converted))
    assert thead.temp.item() == 7.5

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(1, 3, 1, 80, 80, 3)).astype(np.float32)
    xq = rng.normal(size=(1, 4, 80, 80, 3)).astype(np.float32)
    want = np.asarray(jhead.apply(converted, jnp.asarray(xs), jnp.asarray(xq)))
    with torch.no_grad():
        got = thead(torch.from_numpy(xs), torch.from_numpy(xq)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["bare_encoder", "with_head_params", "sund_params", "model_sd"])
def test_encoder_file_loads_as_jax_reads_it(setup, name):
    jhead, variables, paths, _ = setup
    enc_vars = numpy_tree(j_load_encoder(paths[name], sub_variables(_init(jhead, 5), "encoder"),
                                         NAME))
    _tree_equal(enc_vars, sub_variables(variables, "encoder"))
    enc = TVisformer(**SMALL_VISFORMER, device="cpu", seed=8)
    load_encoder_from_checkpoint(paths[name], enc, NAME)
    _assert_state_equal(enc, from_flax(enc_vars))
    enc2 = load_reference_encoder_checkpoint(paths[name], TVisformer(**SMALL_VISFORMER,
                                                                     device="cpu", seed=7))
    _assert_state_equal(enc2, from_flax(enc_vars))


def test_reader_layouts_and_load_variables(setup):
    _, _, paths, _ = setup
    sd, meta = load_variables(paths["sund_params"])
    assert meta == {} and "encoder.stem.conv1.weight" in sd and not any(
        k.startswith("module.") for k in sd)
    assert sd["temp"].dim() == 0 and sd["temp"].item() == 7.5
    sd, meta = load_variables(paths["model_sd"])
    assert meta == {"model": "meta-baseline", "model_args": {"encoder": NAME}}
    assert sorted(strip_prefix({"module.encoder.a": 1, "encoder.b": 2, "temp": 3}, "encoder.")) \
        == ["a", "b"]


def _bad_file(tmp, name, sd):
    path = str(tmp / f"{name}.pth")
    torch.save({"model_sd": sd}, path)
    return path


@pytest.mark.parametrize("case", ["leftover", "shape", "missing", "rank"])
def test_bad_files_raise_as_in_jax(setup, case):
    jhead, variables, _, tmp = setup
    sd = from_flax(variables)
    if case == "leftover":
        sd["encoder.extra.weight"] = torch.zeros(3)
        err, match = ValueError, "unconsumed torch tensors"
    elif case == "shape":
        sd["encoder.pos_embed1"] = sd["encoder.pos_embed1"][:, :, :-1]
        err, match = ValueError, "shape mismatch"
    elif case == "missing":
        del sd["encoder.norm.bn.running_var"]
        err, match = KeyError, "not in state dict"
    else:
        sd[QKV] = sd[QKV][:, :, 0]  # 3-D: neither a conv nor a Linear
        err, match = ValueError, "rank mismatch"
    path = _bad_file(tmp, case, sd)
    with pytest.raises(err, match=match if case != "rank" else "kernel rank mismatch"):
        j_load_head(path, jhead, _init(jhead, 4))
    with pytest.raises(err, match=match):
        load_reference_head_checkpoint(path, _port_head())


def test_unknown_encoder_name_raises_by_name():
    with pytest.raises(KeyError, match="no torch key rule.*nest_micro_80"):
        j_encoder_key_fn_for("not_a_model_nest_micro_80")
    with pytest.raises(KeyError, match="no torch key rule.*'not_a_model_nest_micro_80'"):
        encoder_key_fn_for("not_a_model_nest_micro_80")
    with pytest.raises(KeyError, match="no torch key rule"):
        load_encoder_from_checkpoint("x.pth", _port_head().encoder, "not_a_model")
    # the rest of the zoo resolves to its rule: the port's names are the reference's
    for name in ("nest_micro_80", "resnet12"):
        j_encoder_key_fn_for(name)
        assert encoder_key_fn_for(name)("layer1.conv1.weight", prefix="encoder.") == \
            "encoder.layer1.conv1.weight"


def test_load_model_rebuilds_port_checkpoints(tmp_path):
    narrow = {k: v for k, v in SMALL_VISFORMER.items() if k != "img_size"}
    head = _port_head(3)
    with torch.no_grad():
        head.temp.fill_(4.0)
    save_variables(str(tmp_path / "mb"), head.state_dict(),
                   {"model": "meta-baseline", "encoder": NAME})
    got = load_model(str(tmp_path / "mb"), device="cpu", encoder_args=narrow)
    assert isinstance(got, TMetaBaseline)
    _assert_state_equal(got, head.state_dict())

    from fewshot_vit_tpu_torch.heads.classifier import Classifier, make_classifier

    clf = make_classifier(NAME, encoder_args=narrow, classifier_args={"n_classes": 7},
                          device="cpu", seed=2)
    save_variables(str(tmp_path / "clf"), {"model": clf.state_dict(), "step": 3},  # resume layout
                   {"model": "classifier", "n_classes": 7, "encoder": NAME})
    got = load_model(str(tmp_path / "clf"), device="cpu", encoder_args=narrow)
    assert isinstance(got, Classifier) and got.classifier.linear.weight.shape[0] == 7
    _assert_state_equal(got, clf.state_dict())

    save_variables(str(tmp_path / "anon"), head.state_dict(), {"epoch": 1})
    with pytest.raises(ValueError, match="no 'model'"):
        load_model(str(tmp_path / "anon"), device="cpu")
