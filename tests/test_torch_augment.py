"""Port parity, device-side augmentation: every op of ``data/augment.py``
against the JAX package's on the same numpy images, with the JAX draws
injected (the two packages' random streams differ by construction).

Tolerances on the 0-255 scale: pixel ops 1e-4 (bit-exact where the op is
integer-valued: ``equalize``, ``posterize``, ``solarize``); the shift-based
geometric ops 5e-3 (the JAX resample carries the image as a hi + lo bf16
pair, exact to about 1e-3 grey levels a pass, and ``rotate`` chains three).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot_vit_tpu.data import augment as ja
from fewshot_vit_tpu_torch.data import augment as ta

torch.set_num_threads(1)
PIXEL_TOL, GEOM_TOL = 1e-4, 5e-3
B, S = 6, 24


def _images(seed, b=B, size=S, frac=True):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, size, size, 3)).astype(np.float32)
    if frac:  # off-grid values, as after a resample
        x = np.clip(x + rng.uniform(-0.5, 0.5, x.shape).astype(np.float32), 0, 255)
    return x


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    if tol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# --- draws the JAX functions take from their keys ------------------------------------


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _flip_draw(key, b):
    return _t(_np(jax.random.bernoulli(key, 0.5, (b, 1, 1, 1))).reshape(b))


def _bern(key, p, b):
    return _t(_np(jax.random.bernoulli(key, p, (b, 1, 1, 1))).reshape(b))


def _blur_draws(key, b, p=0.5):
    k1, k2 = jax.random.split(key)
    return {"apply": _t(jax.random.bernoulli(k1, p, (b,))),
            "sigma": _t(jax.random.uniform(k2, (b,), minval=0.1, maxval=2.0))}


def _jitter_draws(key, b, v=0.4):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    factors = np.stack([_np(jax.random.uniform(k, (b,), minval=1 - v, maxval=1 + v))
                        for k in (k1, k2, k3)])
    return {"factors": _t(factors), "order": int(jax.random.randint(k4, (), 0, 6))}


def _erase_draws(key, shape, p=0.25):
    b, h, w, _ = shape
    ks = jax.random.split(key, 6)
    return {"apply": _t(jax.random.bernoulli(ks[0], p, (b,))),
            "target": _t(jax.random.uniform(ks[1], (b,), minval=0.02, maxval=1.0 / 3.0) * h * w),
            "log_r": _t(jax.random.uniform(ks[2], (b,), minval=np.log(0.3),
                                           maxval=np.log(1.0 / 0.3))),
            "offsets": _t(np.stack([_np(jax.random.uniform(ks[3], (b,))),
                                    _np(jax.random.uniform(ks[4], (b,)))])),
            "noise": _t(jax.random.normal(ks[5], shape, jnp.float32))}


def _ra_layers(key, b, num_ops=2, op_prob=0.5):
    layers = []
    for _ in range(num_ops):
        key, k_op, k_mag, k_sign, k_apply = jax.random.split(key, 5)
        layers.append({
            "op": int(jax.random.randint(k_op, (), 0, len(ja._RA_OPS))),
            "mag": _t(jnp.clip(9.0 + 0.5 * jax.random.normal(k_mag, (b,)), 0.0, 10.0)),
            "sign": _t(jnp.where(jax.random.bernoulli(k_sign, 0.5, (b,)), 1.0, -1.0)),
            "apply": _bern(k_apply, op_prob, b)})
    return layers


def _rrc_uniforms(key, b):
    return _t(np.stack([_np(jax.random.uniform(k, (b,))) for k in jax.random.split(key, 4)]))


def _weak_draws(key, b):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {"crop": _rrc_uniforms(k1, b), "flip": _flip_draw(k2, b),
            "randaug": _bern(k3, 0.2, b), "layers": _ra_layers(k4, b)}


def _strong_draws(key, b):
    ks = jax.random.split(key, 5)
    return {"jitter": _jitter_draws(ks[0], b), "blur": _blur_draws(ks[1], b),
            "solarize": _bern(ks[2], 0.5, b), "gray": _bern(ks[3], 0.2, b),
            "strong": _bern(ks[4], 0.5, b)}


# --- pixel ops -----------------------------------------------------------------------

_PER_IMAGE = np.array([0.1, 0.6, 1.0, 1.4, 1.9, 0.0], np.float32)
_PIXEL_CASES = {
    "invert": (lambda m, x: m.invert(x), PIXEL_TOL),
    "solarize": (lambda m, x: m.solarize(x, np.array([0, 64, 128, 129, 200, 256], np.float32)), 0),
    "solarize_add": (lambda m, x: m.solarize_add(x, np.array([0, 10, 33, 55, 99, 110.0],
                                                             np.float32)), PIXEL_TOL),
    "posterize": (lambda m, x: m.posterize(x, np.array([1, 2, 3, 4, 8, 0], np.float32)), 0),
    "autocontrast": (lambda m, x: m.autocontrast(x), PIXEL_TOL),
    "equalize": (lambda m, x: m.equalize(x), 0),
    "brightness": (lambda m, x: m.brightness(x, _PER_IMAGE), PIXEL_TOL),
    "contrast": (lambda m, x: m.contrast(x, _PER_IMAGE), PIXEL_TOL),
    "saturation": (lambda m, x: m.saturation(x, _PER_IMAGE), PIXEL_TOL),
    "sharpness": (lambda m, x: m.sharpness(x, _PER_IMAGE), PIXEL_TOL),
    "grayscale": (lambda m, x: m.grayscale(x), PIXEL_TOL),
}


@pytest.mark.parametrize("name", sorted(_PIXEL_CASES))
def test_pixel_op_matches_jax(name):
    fn, tol = _PIXEL_CASES[name]
    x = _images(1)
    x[1] = np.round(x[1])                      # an integer-valued image
    x[2, :, :, 0] = 77.0                       # a constant channel (autocontrast keeps it)
    x[3] = np.clip(x[3] * 0.1 + 100, 0, 255)   # a narrow histogram
    _close(fn(ta, torch.from_numpy(x)), fn(ja, jnp.asarray(x)), tol)


def test_equalize_integer_step_and_constant_image():
    """PIL's step is integer arithmetic: a 16x16 image (256 pixels) whose
    last non-empty bin holds one pixel gives step 1 exactly; a constant image
    (step 0) comes back unchanged."""
    x = np.zeros((2, 16, 16, 3), np.float32)
    x[0] = np.arange(256, dtype=np.float32).reshape(16, 16, 1)
    x[1] = 200.0
    got = ta.equalize(torch.from_numpy(x))
    _close(got, ja.equalize(jnp.asarray(x)), 0)
    assert torch.equal(got[1], torch.from_numpy(x[1]))


# --- geometric ops -------------------------------------------------------------------


@pytest.mark.parametrize("degrees", [
    [0.0, 90.0, -90.0, 180.0, 270.0, 360.0],   # quarter turns: exact
    [3.0, -7.5, 27.0, -30.0, 44.9, -45.1],     # RandAugment's range and the residual's edges
    [100.0, -135.0, 200.0, 301.0, -250.0, 12.25],
])
def test_rotate_matches_jax(degrees):
    x = _images(2, size=20)
    d = np.array(degrees, np.float32)
    _close(ta.rotate(torch.from_numpy(x), torch.from_numpy(d)),
           ja.rotate(jnp.asarray(x), jnp.asarray(d)), GEOM_TOL)


def test_quarter_turns_are_exact():
    """On integer images: the JAX resample's hi + lo pair holds those exactly."""
    x = _images(3, size=16, frac=False)
    d = np.array([0.0, 90.0, 180.0, -90.0, 270.0, 360.0], np.float32)
    _close(ta.rotate(torch.from_numpy(x), torch.from_numpy(d)),
           ja.rotate(jnp.asarray(x), jnp.asarray(d)), 0)


@pytest.mark.parametrize("axis", ["x", "y"])
def test_shear_and_translate_match_jax(axis):
    x = _images(4)
    f = np.array([0.0, 0.3, -0.3, 0.11, -0.27, 0.05], np.float32)
    t = np.array([0.0, 0.45, -0.45, 0.123, -0.3, 0.01], np.float32)
    z = np.zeros_like(f)
    fx, fy = (f, z) if axis == "x" else (z, f)
    tx, ty = (t, z) if axis == "x" else (z, t)
    _close(ta.shear(torch.from_numpy(x), torch.from_numpy(fx), torch.from_numpy(fy)),
           ja.shear(jnp.asarray(x), jnp.asarray(fx), jnp.asarray(fy)), GEOM_TOL)
    _close(ta.translate(torch.from_numpy(x), torch.from_numpy(tx), torch.from_numpy(ty)),
           ja.translate(jnp.asarray(x), jnp.asarray(tx), jnp.asarray(ty)), GEOM_TOL)


def test_row_shift_edges():
    """Integer and fractional shifts, shifts past the border (fill colour)
    and the default bound (no ``max_shift``)."""
    x = _images(5, b=2, size=12)
    t = np.array([np.linspace(-13, 13, 12), np.linspace(-0.75, 0.75, 12)], np.float32)
    for ms in (None, 13.0):
        _close(ta._row_shift_bilinear(torch.from_numpy(x), torch.from_numpy(t), ms),
               ja._row_shift_bilinear(jnp.asarray(x), jnp.asarray(t), ms), GEOM_TOL)


# --- random ops with injected draws --------------------------------------------------


def test_flip_blur_grayscale_solarize_match_jax():
    x = _images(6)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    key = jax.random.key(3)
    _close(ta.horizontal_flip(None, xt, flip=_flip_draw(key, B)),
           ja.horizontal_flip(key, xj), 0)
    _close(ta.gaussian_blur(None, xt, **_blur_draws(key, B)), ja.gaussian_blur(key, xj),
           PIXEL_TOL)
    _close(ta.random_grayscale(None, xt, apply=_bern(key, 0.2, B)),
           ja.random_grayscale(key, xj), PIXEL_TOL)
    _close(ta.random_solarize(None, xt, apply=_bern(key, 0.5, B)),
           ja.random_solarize(key, xj), 0)


def test_blur_every_image():
    x = _images(7)
    sigma = torch.tensor([0.1, 0.5, 1.0, 1.5, 1.99, 0.3])
    key = jax.random.key(0)
    want = ja.gaussian_blur(key, jnp.asarray(x), p=1.0, radius_min=0.1, radius_max=2.0)
    k1, k2 = jax.random.split(key)
    got = ta.gaussian_blur(None, torch.from_numpy(x), apply=torch.ones(B, dtype=torch.bool),
                           sigma=_t(jax.random.uniform(k2, (B,), minval=0.1, maxval=2.0)))
    _close(got, want, PIXEL_TOL)
    assert not torch.equal(ta.gaussian_blur(None, torch.from_numpy(x), p=1.0, sigma=sigma),
                           torch.from_numpy(x))


@pytest.mark.parametrize("seed", range(6))
def test_color_jitter_matches_jax(seed):
    """Six keys; together they reach several of the six orders."""
    x = _images(8)
    key = jax.random.key(seed)
    _close(ta.color_jitter(None, torch.from_numpy(x), **_jitter_draws(key, B)),
           ja.color_jitter(key, jnp.asarray(x)), PIXEL_TOL)


def test_color_jitter_orders():
    x = torch.from_numpy(_images(9))
    factors = torch.tensor([[1.3] * B, [0.7] * B, [1.2] * B])
    outs = {o: ta.color_jitter(None, x, factors=factors, order=o) for o in range(6)}
    assert len({tuple(v.flatten()[:64].tolist()) for v in outs.values()}) > 1
    want = ta.saturation(ta.contrast(ta.brightness(x, factors[0]), factors[1]), factors[2])
    assert torch.equal(outs[0], want)


@pytest.mark.parametrize("p", [0.25, 1.0])
def test_random_erasing_matches_jax(p):
    x = (_images(10) / 255.0 - 0.45) / 0.22
    key = jax.random.key(int(p * 4))
    want = ja.random_erasing(key, jnp.asarray(x), p=p)
    got = ta.random_erasing(None, torch.from_numpy(x), p=p,
                            **_erase_draws(key, x.shape, p=p))
    _close(got, want, 0)


@pytest.mark.parametrize("op", range(15), ids=lambda i: ja._RA_OPS[i])
def test_rand_augment_op_matches_jax(op):
    """Each of the 15 ops at per-image magnitudes and signs (0 and 10 at the
    ends), through the JAX package's switch."""
    x = _images(11, size=20)
    mag = np.array([0.0, 3.3, 9.0, 9.6, 10.0, 7.2], np.float32)
    sign = np.array([1, -1, 1, -1, -1, 1], np.float32)
    want = ja._ra_apply(op, jnp.asarray(x), jnp.asarray(mag), jnp.asarray(sign))
    got = ta.ra_apply(op, torch.from_numpy(x), torch.from_numpy(mag), torch.from_numpy(sign))
    name = ja._RA_OPS[op]
    tol = GEOM_TOL if name in ("Rotate", "ShearX", "ShearY", "TranslateX", "TranslateY") else (
        0 if name in ("Equalize", "Posterize", "Solarize") else PIXEL_TOL)
    _close(got, want, tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rand_augment_matches_jax(seed):
    """Two layers, ops, magnitudes, signs and applies as JAX drew them from the key."""
    x = _images(12, size=20)
    key = jax.random.key(seed)
    layers = _ra_layers(key, B)
    ops = [ja._RA_OPS[layer["op"]] for layer in layers]
    tol = GEOM_TOL if {"Rotate", "ShearX", "ShearY", "TranslateX", "TranslateY"} & set(ops) \
        else PIXEL_TOL
    _close(ta.rand_augment(None, torch.from_numpy(x), layers=layers),
           ja.rand_augment(key, jnp.asarray(x)), tol)


# --- the pipelines -------------------------------------------------------------------


def test_random_resized_crop_identity_box():
    """Uniforms that give the whole image at its own size: the crop is exact,
    which the pipeline tests below rely on."""
    x = np.random.default_rng(0).integers(0, 256, (3, S, S, 3)).astype(np.uint8)
    u = torch.tensor([[1.0] * 3, [0.5] * 3, [0.0] * 3, [0.0] * 3])
    got = ta.random_resized_crop(None, torch.from_numpy(x), S, scale=(0.08, 1.0),
                                 ratio=(1.0, 1.0), uniforms=u)
    assert torch.equal(got, torch.from_numpy(x).float())


@pytest.fixture
def identity_crop(monkeypatch):
    """The random resized crop is held to JAX on its own (within 1e-2 on the
    0-255 scale, ``test_torch_sund_train.py``); through the pipelines both
    packages take the whole image unchanged, so the ops after it are compared
    at their own tolerances."""
    monkeypatch.setattr(ja, "random_resized_crop",
                        lambda key, images, out_size, **_: images.astype(jnp.float32))
    monkeypatch.setattr(ta, "random_resized_crop",
                        lambda generator, images, out_size, uniforms=None, **_:
                        images.to(torch.float32))


def _u8(seed, b=B):
    return np.random.default_rng(seed).integers(0, 256, (b, S, S, 3)).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 4])
def test_cropaug_matches_jax(identity_crop, seed):
    x = _u8(13)
    key = jax.random.key(seed)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = {"flip": _flip_draw(k2, B), "layers": _ra_layers(k3, B),
             "erase": _erase_draws(k4, (B, S, S, 3))}
    want = ja.make_cropaug_fn(out_size=S)(jnp.asarray(x), key)
    got = ta.make_cropaug_fn(out_size=S)(torch.from_numpy(x), draws=draws)
    _close(got, want, GEOM_TOL / 255.0 / 0.224)


@pytest.mark.parametrize("seed", [0, 2])
def test_dual_view_matches_jax(identity_crop, seed):
    x = _u8(14)
    key = jax.random.key(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = {"weak": _weak_draws(k1, B), "strong": _strong_draws(k2, B),
             "erase": _erase_draws(k3, (B, S, S, 3))}
    want_s, want_w = ja.make_dual_view_fn(out_size=S)(jnp.asarray(x), key)
    got_s, got_w = ta.make_dual_view_fn(out_size=S)(torch.from_numpy(x), draws=draws)
    _close(got_w, want_w, GEOM_TOL / 255.0 / 0.224)
    _close(got_s, want_s, GEOM_TOL / 255.0 / 0.224)


def test_pipelines_draw_from_the_generator():
    """Without injected draws: normalized outputs of the right shape, the
    same from the same seed, other from another; op choices on the host."""
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 28, 28, 3))
                         .astype(np.uint8))
    crop = ta.make_cropaug_fn(out_size=S)
    dual = ta.make_dual_view_fn(out_size=S)
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a, b, c = crop(x, g(0)), crop(x, g(0)), crop(x, g(1))
    assert a.shape == (4, S, S, 3) and a.dtype == torch.float32 and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    s1, w1 = dual(x, g(5))
    s2, w2 = dual(x, g(5))
    assert torch.equal(s1, s2) and torch.equal(w1, w2) and s1.shape == w1.shape == a.shape
    assert ta.host_choice(g(3), 15, 0, 1) == ta.host_choice(g(3), 15, 0, 1)
    assert len({ta.host_choice(g(s), 15, 0, 0) for s in range(20)}) > 1
