"""The port's dataset loaders against the JAX package's on the same fake
files in ``tmp_path``: images, labels, ``n_classes``, mean and std
byte-identical. Then ``memmap_cache`` and the upload of a read-only
memmap."""

import json
import pickle
import shutil
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from fewshot_vit_tpu.data import datasets as jd
from fewshot_vit_tpu_torch.data import datasets as td
from fewshot_vit_tpu_torch.data import staging


def _same(t, j):
    assert t.images.dtype == np.uint8 and t.labels.dtype == np.int32
    np.testing.assert_array_equal(np.asarray(t.images), np.asarray(j.images))
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.n_classes == j.n_classes
    np.testing.assert_array_equal(t.mean, j.mean)
    np.testing.assert_array_equal(t.std, j.std)


def _png(path, rng, size):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(path)


@pytest.mark.parametrize("mini", [False, True])
def test_tiered_imagenet(tmp_path, mini):
    rng = np.random.default_rng(0)
    n_classes, per = (70, 3) if mini else (5, 4)  # mini draws 64 of the classes
    labels = np.repeat(np.arange(n_classes), per) + 3  # offset: labels start at 0 after load
    np.savez(tmp_path / "test_images.npz",
             images=rng.integers(0, 256, (len(labels), 12, 12, 3), dtype=np.uint8))
    with open(tmp_path / "test_labels.pkl", "wb") as f:
        pickle.dump({"labels": labels.tolist()}, f)
    kw = dict(root_path=str(tmp_path), split="test", image_size=8, mini=mini)
    t = td.tiered_imagenet(**kw)
    _same(t, jd.tiered_imagenet(**kw))
    assert t.images.shape == (64 * per if mini else len(labels), 8, 8, 3)
    raw = td.tiered_imagenet(**kw, protocol="raw")
    _same(raw, jd.tiered_imagenet(**kw, protocol="raw"))
    if not mini:  # BGR -> RGB
        src = np.load(tmp_path / "test_images.npz")["images"]
        np.testing.assert_array_equal(raw.images, src[..., ::-1])


def test_cifar_fs(tmp_path):
    rng = np.random.default_rng(1)
    for c in ("zebra", "apple", "maple"):
        for i in range(4):
            _png(tmp_path / "meta-test" / c / f"{i:03d}.png", rng, 32)
    kw = dict(root_path=str(tmp_path), split="test", image_size=40)
    t = td.cifar_fs(**kw)
    _same(t, jd.cifar_fs(**kw))
    assert t.images.shape == (12, 40, 40, 3) and t.n_classes == 3
    np.testing.assert_array_equal(t.mean, np.array([0.5071, 0.4867, 0.4408], np.float32))
    _same(td.cifar_fs(**kw, protocol="raw"), jd.cifar_fs(**kw, protocol="raw"))


def _image_folder(root, rng):
    for c in ("n01", "n02", "n03"):
        for i in range(3):
            _png(root / "images" / c / f"{i}.png", rng, 20)
    (root / "split.json").write_text(json.dumps({"train": ["n03", "n01"], "val": ["n02"]}))


@pytest.mark.parametrize("cache", [False, True])
def test_image_folder(tmp_path, cache):
    _image_folder(tmp_path / "t", np.random.default_rng(2))
    shutil.copytree(tmp_path / "t", tmp_path / "j")  # each package writes its own cache
    kw = dict(split="train", image_size=12, cache_memmap=cache)
    t = td.image_folder(root_path=str(tmp_path / "t"), **kw)
    _same(t, jd.image_folder(root_path=str(tmp_path / "j"), **kw))
    assert t.n_classes == 2 and t.images.shape == (6, 12, 12, 3)
    cache_path = tmp_path / "t" / "_cache_train_12.npy"
    assert cache_path.exists() == cache
    if not cache:
        return
    for again in (t, td.image_folder(root_path=str(tmp_path / "t"), **kw)):  # write, then read
        assert isinstance(again.images, np.memmap) and not again.images.flags.writeable
    _same(again, t)
    # a file added after the cache was written: both loaders refuse the stale cache
    for root in ("t", "j"):
        _png(tmp_path / root / "images" / "n01" / "9.png", np.random.default_rng(3), 20)
    with pytest.raises(ValueError, match="stale cache"):
        td.image_folder(root_path=str(tmp_path / "t"), **kw)
    with pytest.raises(ValueError, match="stale cache"):
        jd.image_folder(root_path=str(tmp_path / "j"), **kw)


def test_fc100(tmp_path):
    rng = np.random.default_rng(4)
    for c in ("b", "a"):
        for i in range(3):
            _png(tmp_path / "val" / c / f"{i}.png", rng, 32)
    (tmp_path / "val" / "notes.txt").write_text("not a class")  # only directories count
    kw = dict(root_path=str(tmp_path), split="val", image_size=16)
    t = td.fc100(**kw)
    _same(t, jd.fc100(**kw))
    assert t.n_classes == 2 and t.images.shape == (6, 16, 16, 3)


def test_cub_drops_the_broken_train_line(tmp_path):
    rng = np.random.default_rng(5)
    for i in range(10):
        _png(tmp_path / "images" / f"{i}.png", rng, 8)  # at image_size: no resize
    n = 5870  # more than 5,864 data lines; the rows cycle over 10 files
    rows = [f"images/{i % 10}.png,w{i // 1000 if i < 5860 else i}" for i in range(n)]
    (tmp_path / "split").mkdir()
    (tmp_path / "split" / "train.csv").write_text("filename,label\n" + "\n".join(rows) + "\n")
    kw = dict(root_path=str(tmp_path), split="train", image_size=8)
    t = td.cub(**kw)
    _same(t, jd.cub(**kw))
    assert len(t.images) == n - 1 and t.n_classes == 6 + (n - 5860) - 1  # w5864 is gone


def test_synthetic_local():
    kw = dict(n_classes=4, n_per_class=3, image_size=32, patch_size=8, seed=1, class_seed=1)
    _same(td.synthetic_local(**kw), jd.synthetic_local(**kw))


def test_memmap_cache_and_upload(tmp_path, monkeypatch):
    images = np.random.default_rng(6).integers(0, 256, (7, 5, 5, 3), dtype=np.uint8)
    mm = staging.memmap_cache(str(tmp_path / "c.npy"), images)
    assert isinstance(mm, np.memmap) and not mm.flags.writeable
    again = staging.memmap_cache(str(tmp_path / "c.npy"))
    assert isinstance(again, np.memmap) and not again.flags.writeable
    monkeypatch.setattr(staging, "UPLOAD_CHUNK_BYTES", 2 * 75)  # 2 images a chunk: 4 chunks
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # torch.from_numpy of a read-only array warns
        up = staging.upload_images(again, "cpu")
    assert up.dtype == torch.uint8 and torch.equal(up, torch.from_numpy(images))
    up[0] = 0  # a copy: the cache on disk is untouched
    np.testing.assert_array_equal(staging.memmap_cache(str(tmp_path / "c.npy")), images)
    writable = staging.upload_images(images, "cpu")  # a writable array is shared, not copied
    assert writable.data_ptr() == images.ctypes.data


def _visformer_configs():
    import pathlib

    import yaml

    from fewshot_vit_tpu_torch.checkpoint.reference import ENCODER_KEY_FNS

    out = []
    for path in sorted(pathlib.Path(__file__).resolve().parent.parent.glob("configs/*.yaml")):
        cfg = yaml.safe_load(path.read_text()) or {}
        enc = cfg.get("encoder") or (cfg.get("model_args") or {}).get("encoder")
        if enc in ENCODER_KEY_FNS:
            out.append((path.name, cfg, enc))
    return out


def test_every_visformer_config_names_ported_datasets_and_keys():
    """Each config of the Visformer family names only datasets the port
    registers, and its encoder has a ``.pth`` key rule."""
    from fewshot_vit_tpu_torch.checkpoint import encoder_key_fn_for
    from fewshot_vit_tpu_torch.core.registry import datasets

    configs = _visformer_configs()
    assert len(configs) >= 20
    for name, cfg, enc in configs:
        encoder_key_fn_for(enc)
        for key, value in cfg.items():
            if key == "dataset" or key.endswith("_dataset"):
                assert value in datasets._ctors, (name, key, value)
