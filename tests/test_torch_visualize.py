"""Port parity, the visualization paths: ``eval/visualize.py`` (the
template's synthesized maps within 1e-6 of float64 and 2e-6 of JAX, the captured ``--real-attn`` maps
within 1e-5 for Visformer, NesT and Swin, ``_jet`` bit-identical,
``overlay`` within 1 of 255, the CLI's JPGs), the capture itself (the same
blocks as JAX's ``sow``, dispatch unchanged), and the sample grids of the
trainers (``RunLogger.image_grid`` / ``visualize_dataset`` pixel-equal,
``visualize_augmented`` within 1 of 255 with JAX's draws injected: the
geometric ops are held to 5e-3 on the 0-255 scale, which truncation to
uint8 turns into at most 1)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fewshot_vit_tpu.core import log as jlog
from fewshot_vit_tpu.core.config import Config as JConfig
from fewshot_vit_tpu.data import augment as ja
from fewshot_vit_tpu.eval import visualize as jv
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.train import runner as jrunner
from fewshot_vit_tpu_torch.checkpoint import load_flax
from fewshot_vit_tpu_torch.core import log as tlog
from fewshot_vit_tpu_torch.core.config import Config
from fewshot_vit_tpu_torch.data import augment as ta
from fewshot_vit_tpu_torch.eval import visualize as tv
from fewshot_vit_tpu_torch.kernels import attention as tka
from fewshot_vit_tpu_torch.models.common import capture_attention
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.train import runner as trunner

from .test_torch_augment import _erase_draws, _flip_draw, _ra_layers, _rrc_uniforms
from .test_torch_zoo import case_setup
from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def test_attention_maps_match_jax():
    """The min-max normalization divides by the map's range, which magnifies
    fp32 rounding: on this input the port lands 5.3e-7 from a float64
    evaluation and XLA:CPU 1.1e-6. So the port is held to float64 within
    1e-6 and to JAX within 2e-6, the sum of the two."""
    dense = np.random.default_rng(0).normal(size=(3, 5, 5, 64)).astype(np.float32)
    want = np.asarray(jv.attention_maps(jnp.asarray(dense)))
    got = tv.attention_maps(torch.from_numpy(dense)).numpy()
    f64 = tv.attention_maps(torch.from_numpy(dense).double()).numpy()
    np.testing.assert_allclose(got, f64, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert got.min() == 0.0 and got.max() == 1.0


def _jax_sow_paths(jm, variables, x):
    _, state = jm.apply(variables, jnp.asarray(x), train=False, mutable=["intermediates"])
    paths = []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                paths.append("/".join(path + (k,)))

    walk(state.get("intermediates", {}), ())
    return paths


def _visformer(fused, seed=0):
    jm = JVisformer(**SMALL_VISFORMER, use_pallas_attn=fused)
    x = np.random.default_rng(seed).normal(size=(2, 80, 80, 3)).astype(np.float32)
    variables = randomize_bn(numpy_tree(jm.init(jax.random.key(seed), jnp.asarray(x))))
    tm = load_flax(TVisformer(**SMALL_VISFORMER, use_pallas_attn=fused, device="cpu"), variables)
    return x, variables, jm, tm


@pytest.mark.parametrize("case", ["visformer-fused", "visformer-plain", "nest", "nest_gpsa",
                                  "nest_2x", "swin", "swin_3conv"])
def test_real_attention_maps_match_jax(case):
    """The deepest captured block's map within 1e-5, from the same captures:
    as many as JAX's sows (with the fused kernel Visformer's stage 2 is not
    captured, in either package); Swin's stitched ``attn_map`` wins."""
    if case.startswith("visformer"):
        x, variables, jm, tm = _visformer(case.endswith("fused"))
    else:
        x, variables, jm, tm = case_setup(case, seed=3)
    want = np.asarray(jv.real_attention_maps(jm, variables, jnp.asarray(x)))
    with torch.no_grad(), capture_attention() as found:
        tm(torch.from_numpy(x))
        got = tv.real_attention_maps(tm, torch.from_numpy(x)).numpy()
    sows = _jax_sow_paths(jm, variables, x)
    assert len(found) == len(sows) > 0
    if case == "visformer-fused":
        assert all(p.startswith("stage3") for p in sows) and len(sows) == 1
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_nest_rel_captures_nothing_in_either_package():
    """The relative-bias NesT attention sows nothing in JAX (whose walk then
    finds no ``intermediates`` at all), so neither package finds a map."""
    x, variables, jm, tm = case_setup("nest_rel", seed=3)
    with pytest.raises(KeyError, match="intermediates"):
        jv.real_attention_maps(jm, variables, jnp.asarray(x))
    with pytest.raises(ValueError, match="captured no attention"):
        tv.real_attention_maps(tm, torch.from_numpy(x))


def test_capture_leaves_dispatch_and_outputs_unchanged(monkeypatch):
    """Inside and outside the capture the fused attention is called for
    stage 2 only, and the forward's outputs are identical."""
    x, _, _, tm = _visformer(True, seed=1)
    calls = []
    orig = tka.fused_mhsa
    monkeypatch.setattr(tka, "fused_mhsa", lambda *a, **k: calls.append(a[0].shape) or
                        orig(*a, **k))
    with torch.no_grad():
        plain = tm(torch.from_numpy(x))
        n = len(calls)
        with capture_attention() as found:
            cap = tm(torch.from_numpy(x))
    assert n == 1 and len(calls) == 2 and calls[0] == calls[1]
    assert len(found) == 1 and found[0][1] == "attn" and found[0][2].shape == (2, 6, 25, 25)
    for a, b in zip(plain, cap):
        assert torch.equal(a, b)


def test_jet_is_bit_identical_and_overlay_within_one():
    v = np.linspace(-0.1, 1.1, 1001, dtype=np.float32).reshape(7, 11, 13)
    np.testing.assert_array_equal(tv._jet(v), jv._jet(v))
    rng = np.random.default_rng(4)
    img = rng.normal(size=(40, 40, 3)).astype(np.float32)
    amap = rng.random((5, 5)).astype(np.float32)
    want = jv.overlay(img, amap, MEAN, STD)
    got = tv.overlay(img, amap, MEAN, STD)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("real", [False, True], ids=["synthesized", "real-attn"])
def test_cli_writes_n_jpgs(tmp_path, capsys, real):
    cfg = tmp_path / "v.yaml"
    cfg.write_text("dataset: synthetic-local\ndataset_args: {n_classes: 4, n_per_class: 5, "
                   "image_size: 80, seed: 1}\nencoder: visformer_micro_80\nmodel_args: "
                   "{encoder_args: {init_channels: 16, embed_dim: 96, depth: [1, 1, 1], "
                   "use_pallas_attn: true}}\n")
    out = tmp_path / "vis"
    maps = tv.main(["--config", str(cfg), "--out", str(out), "--n", "6", "--device", "cpu"]
                   + (["--real-attn"] if real else []))
    assert sorted(os.listdir(out)) == [f"{i}.jpg" for i in range(6)]
    assert Image.open(out / "0.jpg").size == (80, 80)
    assert maps.shape == (6, 5, 5) and maps.min() >= 0.0 and maps.max() <= 1.0
    assert "wrote 6 overlays" in capsys.readouterr().out


class _DS:
    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)


def _png(path):
    return np.asarray(Image.open(path))


def test_image_grid_and_visualize_dataset_match_jax(tmp_path):
    imgs = np.random.default_rng(5).integers(0, 256, (30, 12, 10, 3)).astype(np.uint8)
    jl, tl = jlog.RunLogger(str(tmp_path / "j"), stdout=False), \
        tlog.RunLogger(str(tmp_path / "t"), stdout=False)
    for n in (1, 5, 16):
        np.testing.assert_array_equal(_png(tl.image_grid(f"g{n}", imgs[:n])),
                                      _png(jl.image_grid(f"g{n}", imgs[:n])))
    got, want = tl.visualize_dataset(_DS(imgs), "train"), jl.visualize_dataset(_DS(imgs), "train")
    assert os.path.basename(got) == os.path.basename(want) == "visualize_train.png"
    np.testing.assert_array_equal(_png(got), _png(want))
    assert tlog.RunLogger(None).image_grid("x", imgs) is None


def test_visualize_datasets_writes_one_grid_per_split(tmp_path):
    imgs = np.zeros((4, 8, 8, 3), np.uint8)
    tl = tlog.RunLogger(str(tmp_path), stdout=False)
    trunner.visualize_datasets(tl, Config({}), train_dataset=_DS(imgs))
    assert not list(tmp_path.glob("*.png"))  # off unless the config asks
    trunner.visualize_datasets(tl, Config({"visualize_datasets": True}),
                               train_dataset=_DS(imgs), val_dataset=None, fs_dataset=_DS(imgs))
    assert sorted(p.name for p in tmp_path.glob("*.png")) == ["visualize_fs_dataset.png",
                                                               "visualize_train_dataset.png"]


def test_visualize_augmented_matches_jax_with_its_draws(tmp_path):
    """cropaug on 16 of 20 images, JAX's ``key(0)`` draws injected."""
    imgs = np.random.default_rng(6).integers(0, 256, (20, 32, 32, 3)).astype(np.uint8)
    on = {"visualize_datasets": True}
    jl, tl = jlog.RunLogger(str(tmp_path / "j"), stdout=False), \
        tlog.RunLogger(str(tmp_path / "t"), stdout=False)
    jrunner.visualize_augmented(jl, JConfig(on), _DS(imgs), ja.make_cropaug_fn(out_size=32),
                                MEAN, STD)
    k1, k2, k3, k4 = jax.random.split(jax.random.key(0), 4)
    draws = {"crop": _rrc_uniforms(k1, 16), "flip": _flip_draw(k2, 16),
             "layers": _ra_layers(k3, 16), "erase": _erase_draws(k4, (16, 32, 32, 3))}
    trunner.visualize_augmented(tl, Config(on), _DS(imgs), ta.make_cropaug_fn(out_size=32),
                                MEAN, STD, torch.device("cpu"), draws=draws)
    want, got = _png(tmp_path / "j" / "visualize_train_aug.png"), \
        _png(tmp_path / "t" / "visualize_train_aug.png")
    assert got.shape == want.shape == (128, 128, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_visualize_augmented_dual_view_names(tmp_path):
    """SUN's two views, from the generator (no draws injected)."""
    imgs = np.random.default_rng(7).integers(0, 256, (5, 32, 32, 3)).astype(np.uint8)
    tl = tlog.RunLogger(str(tmp_path), stdout=False)
    trunner.visualize_augmented(tl, Config({"visualize_datasets": True}), _DS(imgs),
                                ta.make_dual_view_fn(out_size=32), MEAN, STD, "cpu",
                                views=("strong", "weak"))
    assert sorted(p.name for p in tmp_path.glob("*.png")) == ["visualize_train_strong.png",
                                                               "visualize_train_weak.png"]
    assert _png(tmp_path / "visualize_train_weak.png").shape == (64, 96, 3)
