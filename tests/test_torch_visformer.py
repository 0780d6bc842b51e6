"""Port parity, encoder: a narrow Visformer whose JAX-initialized weights are
carried across with ``from_flax``; unfolded and folded forwards, the fold
itself, the fused-attention flag, and the memory order the encoder computes
in."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.models.fold import fold_visformer as j_fold
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu_torch.checkpoint import from_flax, load_flax
from fewshot_vit_tpu_torch.core import trace
from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.data.augment import make_dual_view_fn
from fewshot_vit_tpu_torch.kernels import attention as tk
from fewshot_vit_tpu_torch.models.fold import fold_visformer as t_fold
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn, strided_layer_inputs

torch.set_num_threads(1)
TOL = 1e-4  # fp32 convs and GEMMs summed in another order by XLA:CPU and torch


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(0).normal(size=(2, 80, 80, 3)).astype(np.float32)
    jm = JVisformer(**SMALL_VISFORMER)
    variables = randomize_bn(numpy_tree(jm.init(jax.random.key(0), jnp.asarray(x))))
    return x, variables


def _port(variables, **kw):
    return load_flax(TVisformer(**SMALL_VISFORMER, device="cpu", **kw), variables)


def _check(got, want):
    dense, pooled = got
    assert dense.shape == (2, 5, 5, 192) and pooled.shape == (2, 192)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want[1]), rtol=TOL, atol=TOL)


def test_unfolded_forward_matches_jax(setup):
    x, variables = setup
    want = JVisformer(**SMALL_VISFORMER).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        _check(_port(variables)(torch.from_numpy(x)), want)


def test_folded_forward_matches_jax(setup):
    x, variables = setup
    folded = numpy_tree(j_fold(variables))
    want = JVisformer(**SMALL_VISFORMER, fold_bn=True).apply(folded, jnp.asarray(x))
    port = _port(variables)
    folded_port = port.clone(fold_bn=True)
    folded_port.load_state_dict(t_fold(port.state_dict()))
    with torch.no_grad():
        _check(folded_port(torch.from_numpy(x)), want)


def test_fold_of_converted_equals_converted_fold(setup):
    _, variables = setup
    got = t_fold(from_flax(variables))
    want = from_flax(numpy_tree(j_fold(variables)))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def test_fused_attention_flag_on_cpu(setup):
    """The flag routes stage 2 (T=100) through ``attention_core``; on CPU
    tensors that is the plain version, so both settings agree."""
    x, variables = setup
    before = tk.fused_mhsa.launches
    with torch.no_grad():
        off = _port(variables)(torch.from_numpy(x))
        on = _port(variables, use_pallas_attn=True)(torch.from_numpy(x))
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)  # fp32 softmax, two formulations
    assert tk.fused_mhsa.launches == before


def test_load_flax_is_strict(setup):
    _, variables = setup
    params = dict(variables["params"])
    params["extra"] = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError):
        _port({**variables, "params": params})
    params = {k: v for k, v in variables["params"].items() if k != "pos_embed2"}
    with pytest.raises(RuntimeError):
        _port({**variables, "params": params})


def test_training_mode_raises():
    """Only for a folded encoder, which has no BN left to train; an unfolded
    one runs in training mode (``tests/test_torch_train_mode.py``)."""
    folded = TVisformer(**SMALL_VISFORMER, device="cpu", fold_bn=True)
    with pytest.raises(ValueError, match="fold_bn"):
        folded.train()
    assert not folded.training
    model = TVisformer(**SMALL_VISFORMER, device="cpu").train()
    dense, pooled = model(torch.zeros(2, 80, 80, 3))
    assert dense.shape == (2, 5, 5, 192) and pooled.requires_grad


def _weak_view():
    images = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 84, 84, 3),
                                                                 dtype=np.uint8))
    return make_dual_view_fn()(images, torch.Generator().manual_seed(2))[1]


@pytest.mark.parametrize("make_input,relayouts", [
    (_weak_view, 1),  # resample_boxes' einsum leaves H and W swapped in memory
    (lambda: torch.randn(2, 3, 80, 80, generator=torch.Generator().manual_seed(3))
     .permute(0, 2, 3, 1), 1),  # an NHWC view of NCHW memory
    (lambda: torch.randn(2, 80, 80, 3, generator=torch.Generator().manual_seed(3)), 0),
], ids=["dual_view_weak", "nchw_memory", "contiguous"])
def test_encoder_computes_on_nhwc_contiguous_activations(make_input, relayouts):
    """Whatever the input's strides, every layer of the encoder reads an
    NHWC-contiguous input (a strided one is copied once at the entry), so
    each 1x1 is one GEMM; the output is that of the contiguous input, bit
    for bit."""
    encoder = models.make("visformer_micro_80", device="cpu")
    x = make_input()
    before = trace.counters().get("encoder.relayout", 0)
    with torch.no_grad():
        (dense, pooled), strided = strided_layer_inputs(encoder, lambda: encoder(x))
        counted = trace.counters().get("encoder.relayout", 0) - before
        want_dense, want_pooled = encoder(x.contiguous())
    assert strided == []
    assert counted == relayouts
    assert torch.equal(dense, want_dense) and torch.equal(pooled, want_pooled)
