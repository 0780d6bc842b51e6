"""Port parity, the encoder zoo: every encoder name of the JAX registry is
registered in the port; at full width each one's flax tree (``jax.eval_shape``
of ``init``, nothing computed) maps through ``from_flax``'s key rule onto
exactly the port's state-dict keys and shapes; at narrow widths every code
path's eval-mode forward matches flax on the same weights carried
across with ``load_flax`` (the flax tree's shapes from ``jax.eval_shape``
of ``init``, its values drawn with numpy); ``swin_nano_patch4_window5_80`` refuses 80 px in
both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fewshot_vit_tpu.models as jmodels
from fewshot_vit_tpu.models.resnet12 import ResNet12Drop as JResNet12Drop
from fewshot_vit_tpu.core.registry import models as j_registry
from fewshot_vit_tpu_torch import models as tmodels
from fewshot_vit_tpu_torch.checkpoint import from_flax, load_flax
from fewshot_vit_tpu_torch.core.registry import models as t_registry

from .torch_port_helpers import numpy_tree, randomize_bn

torch.set_num_threads(1)
FWD_TOL = 1e-5  # of the output's max-abs: fp32 sums in another order

# narrow cases, one per code path: (class name, constructor args, image size)
CASES = {
    "nest": ("Nest", dict(embed_dims=(16, 32, 48), num_heads=(2, 2, 4), depths=(1, 1, 1)), 80),
    "nest_gpsa": ("Nest", dict(embed_dims=(16, 32, 48), num_heads=(2, 4, 4), depths=(1, 1, 1),
                               gpsa_levels=2), 80),
    "nest_rel": ("Nest", dict(embed_dims=(16, 32, 48), num_heads=(2, 2, 4), depths=(1, 1, 1),
                              rel_bias=True), 80),
    "nest_resembed": ("Nest", dict(embed_dims=(16, 32, 48), num_heads=(2, 2, 4),
                                   depths=(1, 1, 1), conv_stem=True, stem_hidden=8), 80),
    "nest_2x": ("Nest", dict(embed_dims=(16, 32, 48), num_heads=(2, 2, 4), depths=(1, 1, 1),
                             conv_stem=True, stem_hidden=8, last_level_2x=True), 80),
    "swin": ("SwinTransformer", dict(img_size=48, window_size=6, embed_dim=16, depths=(2, 2),
                                     num_heads=(2, 2)), 48),
    "swin_3conv": ("SwinTransformer", dict(img_size=80, window_size=5, embed_dim=16,
                                           depths=(2, 2, 2), num_heads=(2, 2, 4),
                                           conv_stem=True, stem_hidden=8), 80),
    "swin_adapool": ("SwinTransformer", dict(img_size=80, window_size=5, embed_dim=16,
                                             depths=(2, 2, 2), num_heads=(2, 2, 4),
                                             conv_stem=True, stem_hidden=8,
                                             merge_smooth=True), 80),
    "levit": ("Levit", dict(embed_dim=(16, 24, 32), key_dim=8, depth=(1, 1, 1),
                            num_heads=(2, 3, 4), stem_hidden=8), 80),
    "lvvit": ("LVViT", dict(embed_dim=24, depth=2, num_heads=2, stem_hidden=8), 80),
    "deit": ("VisionTransformer", dict(img_size=48, patch_size=8, embed_dim=24, depth=2,
                                       num_heads=2), 48),
    "resnet_basic": ("ResNet", dict(layers=(1, 1, 1, 1)), 32),
    "resnet_bottleneck": ("ResNet", dict(layers=(1, 1, 1, 1), bottleneck=True), 32),
    "resnet12": ("ResNet12", dict(channels=(8, 16, 24, 32)), 80),
    "resnet12_drop": ("ResNet12Drop", dict(channels=(8, 16, 24, 32)), 80),
    "convnet4": ("ConvNet4", dict(hid_dim=8, z_dim=8), 80),
}
# rates at 0 unless a test sets them (the JAX defaults are not all 0)
_NO_DROP = {"Nest": {"drop_path_rate": 0.0}, "SwinTransformer": {"drop_path_rate": 0.0},
            "LVViT": {"drop_path_rate": 0.0}, "ResNet12Drop": {"drop_rate": 0.0}}

# each registered name's input edge
SIZES = {"swin_nano_patch4_window5_80": 96, "visformer_small": 224,
         **{n: 224 for n in ("deit_tiny_patch16_224", "deit_small_patch16_224",
                             "deit_base_patch16_224", "deit_nano_patch16_224")},
         "deit_nano_patch6_84": 84, "deit_micro_patch6_84": 84}


def case_models(case, **overrides):
    """(flax module, port module on the CPU) of a narrow case."""
    cls, kw, _ = CASES[case]
    kw = {**_NO_DROP.get(cls, {}), **kw, **overrides}
    jcls = JResNet12Drop if cls == "ResNet12Drop" else getattr(jmodels, cls)
    return jcls(**kw), getattr(tmodels, cls)(**kw, device="cpu")


def draw_variables(jm, *inputs, seed=0):
    """Flax variables of ``jm`` for ``inputs``: the tree of its ``init``
    (``jax.eval_shape``, nothing compiled), filled from ``numpy`` at ``seed``.
    Kernels are LeCun-normal; every other parameter (biases, LayerNorm and
    BN affines, bias tables, gates, embeddings) and the BN statistics are
    drawn away from their init, so a fault in any mapping shows."""
    shapes = jax.eval_shape(jm.init, jax.random.key(0), *map(jnp.asarray, inputs))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif name in ("scale", "gating_param"):
            v = 1 + rng.normal(0, 0.1, s.shape)
        elif name == "num_batches_tracked":
            v = np.zeros(s.shape)
        else:
            v = rng.normal(0, 0.1, s.shape)
        return np.asarray(v, np.float32)

    return randomize_bn(numpy_tree(jax.tree_util.tree_map_with_path(draw, shapes)), seed + 1)


def case_setup(case, seed=0, batch=2, **overrides):
    """(x, flax variables, flax module, port module with those weights)."""
    jm, tm = case_models(case, **overrides)
    size = CASES[case][2]
    x = np.random.default_rng(seed).normal(size=(batch, size, size, 3)).astype(np.float32)
    variables = draw_variables(jm, x, seed=seed)
    return x, variables, jm, load_flax(tm, variables)


def assert_rel_close(got, want, rel, what=""):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-6), (what, err, np.abs(want).max())


# every encoder of the JAX registry: the names its models package registers
JAX_ENCODERS = sorted(n for n, ctor in j_registry._ctors.items()
                      if ctor.__module__.startswith("fewshot_vit_tpu.models"))


def test_registry_holds_every_jax_encoder():
    assert len(JAX_ENCODERS) == 29
    missing = [n for n in JAX_ENCODERS if n not in t_registry._ctors]
    assert not missing, missing


@pytest.mark.parametrize("name", JAX_ENCODERS)
def test_full_width_state_dict_is_the_flax_tree(name):
    """jax.eval_shape of init (no compute) -> the key rule -> exactly the
    port's state-dict keys and shapes (the port built on the meta device)."""
    size = SIZES.get(name, 80)
    jm = j_registry.make(name)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, size, size, 3))))
    zeros = jax.tree_util.tree_map(  # zero-stride views: nothing allocated but the copies
        lambda s: np.broadcast_to(np.zeros((1,), np.float32), s.shape) if s.shape
        else np.zeros((), np.float32), shapes)
    with torch.device("meta"):
        port = t_registry.make(name, device="meta")
    target = port.state_dict()
    got = from_flax(zeros, like=target, encoder=name)
    assert sorted(got) == sorted(target)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(target[k].shape), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_matches_jax(case):
    x, variables, jm, port = case_setup(case)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w, what in zip(got, want, ("dense", "pooled")):
        assert tuple(g.shape) == tuple(w.shape), what
        assert_rel_close(g.numpy(), w, FWD_TOL, what)


def test_swin_nano_refuses_80px_in_both_and_agrees_at_96():
    jm = j_registry.make("swin_nano_patch4_window5_80")
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 80, 80, 3))))
    port = t_registry.make("swin_nano_patch4_window5_80", device="cpu")
    with pytest.raises(ValueError, match="built for 96x96 inputs"):
        port(torch.zeros(1, 80, 80, 3))
    # as the port's pretrain builds it for image_size 80
    with pytest.raises(ValueError, match="window 6 does not tile the 20x20"):
        t_registry.make("swin_nano_patch4_window5_80", img_size=80, device="cpu")
    x = np.random.default_rng(1).normal(size=(1, 96, 96, 3)).astype(np.float32)
    variables = draw_variables(jm, x, seed=1)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = load_flax(port, variables)(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert_rel_close(g.numpy(), w, FWD_TOL)
