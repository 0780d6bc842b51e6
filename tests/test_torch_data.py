"""Port parity, host data: episode indices, synthetic images, normalize."""

import numpy as np
import pytest
import torch

from fewshot_vit_tpu.data import datasets as jdatasets
from fewshot_vit_tpu.data.transforms import normalize as jnormalize
from fewshot_vit_tpu.eval.episodic import sample_episode_indices as j_sample
from fewshot_vit_tpu_torch.data import datasets as tdatasets
from fewshot_vit_tpu_torch.data.transforms import normalize as tnormalize
from fewshot_vit_tpu_torch.eval.episodic import sample_episode_indices as t_sample

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    kw = dict(n_classes=12, n_per_class=30, image_size=16, seed=5)
    return jdatasets.synthetic(**kw), tdatasets.synthetic(**kw)


def test_synthetic_is_byte_identical(pair):
    jd, td = pair
    assert td.images.dtype == np.uint8 and td.labels.dtype == np.int32
    np.testing.assert_array_equal(td.images, jd.images)
    np.testing.assert_array_equal(td.labels, jd.labels)
    assert td.n_classes == jd.n_classes


@pytest.mark.parametrize("seed,way,n_per,ep_per_batch,n_episodes", [
    (12345, 5, 16, 8, 40),
    (7, 5, 20, 4, 13),   # ragged last batch
    (0, 3, 2, 1, 5),
    (99, 12, 6, 16, 32),  # every class in every episode
])
def test_episode_indices_exact(pair, seed, way, n_per, ep_per_batch, n_episodes):
    jd, td = pair
    want = j_sample(jd, n_episodes, way, n_per, ep_per_batch, seed)
    got = t_sample(td, n_episodes, way, n_per, ep_per_batch, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_normalize_matches(pair):
    jd, _ = pair
    want = np.asarray(jnormalize(jd.images[:7]))
    got = tnormalize(torch.from_numpy(jd.images[:7])).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # fp32 rounding only


@pytest.mark.parametrize("protocol", ["resize_crop", "raw", "resize_short"])
def test_mini_imagenet_protocols_match_jax(tmp_path, protocol):
    """A fake 84x84 miniImageNet pickle: ``raw`` keeps the native images for
    the device-side crop, the two resizing protocols give the JAX loader's
    bytes."""
    import pickle

    rng = np.random.default_rng(0)
    pack = {"data": rng.integers(0, 256, (6, 84, 84, 3), dtype=np.uint8),
            "labels": [3, 3, 4, 4, 5, 5]}
    with open(tmp_path / "miniImageNet_category_split_train_phase_train.pickle", "wb") as f:
        pickle.dump(pack, f)
    kw = dict(root_path=str(tmp_path), split="train", image_size=80, protocol=protocol)
    want, got = jdatasets.mini_imagenet(**kw), tdatasets.mini_imagenet(**kw)
    side = 84 if protocol == "raw" else 80
    assert got.images.shape == (6, side, side, 3) and got.images.dtype == np.uint8
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.n_classes == want.n_classes == 3
    if protocol == "raw":
        np.testing.assert_array_equal(got.images, pack["data"])
