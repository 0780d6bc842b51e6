"""Port parity, the encoder zoo's weights in and out: ``fold_levit`` and
``fold_resnet12`` against the JAX package's folders; ``eval/run.py
--fold-bn --device cpu`` over a narrow LeViT from a reference ``.pth``
against JAX ``evaluate`` over the JAX-folded head on the same episodes
(per-episode accuracies bit-identical); ``--fold-bn`` over NesT refused as
JAX refuses it; and per family a reference-format ``.pth`` (the reference's
buffers included) that JAX's ``convert_by_rule`` reads back to the flax tree
and the port loads tensor for tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.checkpoint.torch_convert import ENCODER_KEY_FNS as J_KEY_FNS
from fewshot_vit_tpu.checkpoint.torch_convert import convert_by_rule as j_convert
from fewshot_vit_tpu.core.config import load_config as j_load_config
from fewshot_vit_tpu.core.registry import models as j_models
from fewshot_vit_tpu.data.datasets import synthetic_local as j_synthetic_local
from fewshot_vit_tpu.eval.episodic import evaluate as j_evaluate
from fewshot_vit_tpu.eval.run import load_model_for_eval as j_load_model_for_eval
from fewshot_vit_tpu.heads.meta_baseline import MetaBaseline as JMetaBaseline
from fewshot_vit_tpu.models import fold as jfold
from fewshot_vit_tpu.models.levit import Levit as JLevit
from fewshot_vit_tpu_torch.checkpoint import from_flax
from fewshot_vit_tpu_torch.checkpoint.reference import _BUFFERS
from fewshot_vit_tpu_torch.core.rng import DEFAULT_SEED
from fewshot_vit_tpu_torch.eval import run
from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline as TMetaBaseline
from fewshot_vit_tpu_torch.models import fold as tfold
from fewshot_vit_tpu_torch.models.levit import Levit as TLevit
from fewshot_vit_tpu_torch.train.runner import load_encoder_from_checkpoint

from .test_torch_zoo import CASES, assert_rel_close, case_models, case_setup, draw_variables
from .torch_port_helpers import numpy_tree

torch.set_num_threads(1)
FOLD = {"levit": (jfold.fold_levit, tfold.fold_levit),
        "resnet12": (jfold.fold_resnet12, tfold.fold_resnet12)}


@pytest.mark.parametrize("case", sorted(FOLD))
def test_fold_matches_jax(case):
    x, variables, jm, port = case_setup(case)
    j_fold, t_fold = FOLD[case]
    jfolded = numpy_tree(j_fold(variables))
    assert "batch_stats" not in jfolded  # no BN survives either fold
    folded = port.clone(fold_bn=True)
    got = t_fold(port.state_dict())
    want = from_flax(jfolded, like=folded)
    assert sorted(got) == sorted(want) == sorted(folded.state_dict())
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    folded.load_state_dict(got)
    j_out = jax.jit(jm.clone(fold_bn=True).apply)(jfolded, jnp.asarray(x))
    with torch.no_grad():
        t_out, unfolded = folded(torch.from_numpy(x)), port(torch.from_numpy(x))
    for g, w, u in zip(t_out, j_out, unfolded):
        assert_rel_close(g.numpy(), w, 1e-5)
        assert_rel_close(g.numpy(), u.numpy(), 1e-5)  # the fold is exact up to rounding


NARROW_LEVIT = CASES["levit"][1]
DATA = dict(n_classes=6, n_per_class=20, image_size=80, seed=2)
N_EP = 8


@pytest.fixture(scope="module")
def levit_pth(tmp_path_factory):
    """A reference-format MetaBaseline ``.pth`` around a narrow LeViT, with
    the reference's buffers, and the JAX registry's ``levit_micro_80`` taking
    the config's widths for this module."""
    tmp = tmp_path_factory.mktemp("levit")
    jhead = JMetaBaseline(encoder=JLevit(**NARROW_LEVIT))
    variables = draw_variables(jhead, np.zeros((1, 2, 1, 80, 80, 3), np.float32),
                               np.zeros((1, 2, 80, 80, 3), np.float32), seed=5)
    variables["params"]["temp"] = np.asarray(12.0, np.float32)
    thead = TMetaBaseline(TLevit(**NARROW_LEVIT, device="cpu"))
    sd = with_reference_buffers(from_flax(variables, like=thead), thead)
    path = tmp / "max-va.pth"
    torch.save({"model": "meta-baseline", "model_args": {"encoder": "levit_micro_80"},
                "model_sd": sd}, str(path))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(j_models._ctors, "levit_micro_80", lambda **kw: JLevit(**kw))
        yield tmp, path


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "fold_bn"])
def test_eval_cli_levit_matches_jax_bit_for_bit(levit_pth, capsys, fold):
    tmp, path = levit_pth
    cfg = tmp / f"eval_{fold}.yaml"
    args = ", ".join(f"{k}: {list(v) if isinstance(v, tuple) else v}"
                     for k, v in NARROW_LEVIT.items())
    cfg.write_text("dataset: synthetic-local\n" + f"dataset_args: {DATA}\n".replace("'", "")
                   + f"encoder: levit_micro_80\nmodel_args: {{encoder_args: {{{args}}}}}\n"
                   + f"load: {path}\n")
    accs = run.main(["--config", str(cfg), "--episodes", str(N_EP), "--device", "cpu"]
                    + (["--fold-bn"] if fold else []))
    assert "test epoch 1: acc=" in capsys.readouterr().out
    jh, jv = j_load_model_for_eval(j_load_config(str(cfg)))
    if fold:
        jh, jv = jfold.fold_encoder_in_head(jh, jv)
    want = np.asarray(j_evaluate(jh, jv, j_synthetic_local(**DATA), n_episodes=N_EP,
                                 ep_per_batch=8, seed=DEFAULT_SEED)[2])
    assert want.shape == (N_EP,) and 0 < want.mean() < 1  # a non-trivial protocol
    np.testing.assert_array_equal(accs, want)


def test_fold_bn_refuses_other_families_as_jax_does():
    jm, tm = case_models("nest")
    jhead = JMetaBaseline(encoder=jm)
    with pytest.raises(NotImplementedError) as j_err:
        jfold.fold_encoder_in_head(jhead, {"params": {"encoder": {}}})
    with pytest.raises(NotImplementedError) as t_err:
        tfold.fold_encoder_in_head(TMetaBaseline(tm))
    assert str(t_err.value) == str(j_err.value)
    assert "supported: ['Levit', 'ResNet12', 'Visformer']" in str(t_err.value)


def with_reference_buffers(sd, module):
    """``sd`` plus what a reference state dict also holds: each BN's
    ``num_batches_tracked`` and the static index / mask buffers."""
    out = dict(sd)
    for k in sd:
        if k.endswith("running_var"):
            out[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    for name, buf in module.named_buffers():
        if name.endswith(_BUFFERS) and name not in out and buf is not None:
            out[name] = buf.clone()
    return out


# one registry name per family: its key rule reads the family's files
PTH_CASES = {"nest_rel": "nest_micro_v2_rel_80", "swin_3conv": "swin_micro_resembed_80",
             "levit": "levit_micro_80", "lvvit": "lvvit_micro_80",
             "deit": "deit_tiny_patch16_224", "resnet_basic": "resnet18",
             "resnet12": "resnet12", "resnet12_drop": "resnet12-drop",
             "convnet4": "convnet4"}


@pytest.mark.parametrize("case", sorted(PTH_CASES))
def test_reference_pth_round_trip_per_family(case, tmp_path):
    name = PTH_CASES[case]
    _, variables, jm, port = case_setup(case, seed=2)
    sd = from_flax(variables, like=port)
    file_sd = with_reference_buffers(sd, port)
    if case in ("swin_3conv", "levit", "nest_rel"):
        assert len(file_sd) > len(sd) + sum(k.endswith("num_batches_tracked") for k in file_sd)
    path = str(tmp_path / "enc.pth")
    torch.save({"model": "classifier", "model_sd": {f"encoder.{k}": v
                                                    for k, v in file_sd.items()}}, path)
    # the JAX package's converter reads the file back to the flax tree
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1,) + (CASES[case][2],) * 2 + (3,)))
    j_sd = {k: v.numpy() for k, v in file_sd.items()}
    back = j_convert(shapes, j_sd, lambda col, path: J_KEY_FNS[name](col, path))
    flat = jax.tree_util.tree_leaves_with_path(back)
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat) == len(want)
    for p, v in flat:
        np.testing.assert_array_equal(v, want[p], err_msg=str(p))
    # the port loads it tensor for tensor
    fresh = case_models(case)[1]
    load_encoder_from_checkpoint(path, fresh, name)
    got = fresh.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("fault", ["leftover", "shape"])
def test_reference_pth_faults_raise_in_both(fault, tmp_path):
    _, variables, jm, port = case_setup("levit", seed=2)
    sd = with_reference_buffers(from_flax(variables, like=port), port)
    if fault == "leftover":
        sd["blocks.0.m.extra.weight"] = torch.zeros(2)
        err, match = ValueError, "unconsumed torch tensors"
    else:
        sd["blocks.0.m.qkv.c.weight"] = sd["blocks.0.m.qkv.c.weight"][:, :-1]
        err, match = ValueError, "shape mismatch"
    path = str(tmp_path / "bad.pth")
    torch.save({"model_sd": sd}, path)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 80, 80, 3)))
    with pytest.raises(err, match=match):
        j_convert(shapes, {k: v.numpy() for k, v in sd.items()},
                  lambda col, p: J_KEY_FNS["levit_micro_80"](col, p))
    with pytest.raises(err, match=match):
        load_encoder_from_checkpoint(path, case_models("levit")[1], "levit_micro_80")
