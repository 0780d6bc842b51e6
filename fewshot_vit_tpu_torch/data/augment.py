"""Device-side image augmentation (counterpart: ``fewshot_vit_tpu/data/augment.py``).

The same functions as the JAX package's, batched over (B, H, W, 3) float
images in [0, 255] on the images' device:

  * ``random_resized_crop`` and ``horizontal_flip``;
  * the PIL-style pixel ops (``invert`` ... ``grayscale``), ``equalize`` on a
    per-(image, channel) ``bincount`` with PIL's exact integer step;
  * the affine ops ``rotate`` / ``shear`` / ``translate`` as passes of one
    constant shift per row (``_row_shift_bilinear``): a two-tap gather and a
    lerp, with PIL's inside test, border clamp and timm's fill colour;
  * ``gaussian_blur`` (a grouped conv with per-image weights),
    ``random_grayscale``, ``random_solarize``, ``color_jitter``,
    ``random_erasing`` (timm 'pixel' mode, on the normalized tensor);
  * ``rand_augment`` (timm ``rand-m9-mstd0.5-inc1``: one op per layer for the
    whole batch, magnitude, sign and apply per image);
  * the pipelines ``weak_augment``, ``strong_from_weak``,
    ``make_dual_view_fn`` (SUN) and ``make_cropaug_fn`` (phase 1).

Randomness: every random function takes a ``torch.Generator`` (on the
images' device) and, as keyword arguments, the draws themselves, which then
replace the generator's. The batch-level choices (RandAugment's op per layer,
ColorJitter's order) are drawn on the host from the generator's seed, so
choosing never waits for the card. The pipelines take their draws as one
dict per stage (see ``make_dual_view_fn``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .patches import resample_boxes
from .transforms import MEAN, STD, normalize

# PIL-style luminance (ITU-R 601-2)
_LUMA = (0.299, 0.587, 0.114)
# timm fill colour of the geometric ops: round(255 * IMAGENET_MEAN)
_FILL = (124.0, 116.0, 104.0)
Draws = Optional[Dict[str, object]]


def _per_image(v, x: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,) value as a tensor broadcastable over (B, H, W, C)."""
    t = torch.as_tensor(v, dtype=torch.float32, device=x.device)
    return t.reshape((-1,) + (1,) * (x.dim() - 1)) if t.dim() else t


def _rand(generator: Optional[torch.Generator], x: torch.Tensor, *shape: int) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=x.device)


def _uniform(generator, x, n: int, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * _rand(generator, x, n)


def _bernoulli(generator, x, n: int, p: float) -> torch.Tensor:
    return _rand(generator, x, n) < p


def host_choice(generator: Optional[torch.Generator], n: int, *salt: int) -> int:
    """An integer in [0, n) for a batch-level choice, drawn on the host: from
    (the generator's seed, ``salt``) or, without a generator, from torch's
    default one."""
    if generator is None:
        return int(torch.randint(n, ()).item())
    return int(np.random.default_rng([generator.initial_seed(), *salt]).integers(n))


def _gray(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 1) luminance."""
    return (x[..., 0:1] * _LUMA[0] + x[..., 1:2] * _LUMA[1]) + x[..., 2:3] * _LUMA[2]


def _blend(a: torch.Tensor, b: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL ImageEnhance: b + factor * (a - b), clipped to [0, 255]."""
    return torch.clamp(b + factor * (a - b), 0.0, 255.0)


# --- geometric ----------------------------------------------------------------


def _row_shift_bilinear(x: torch.Tensor, t: torch.Tensor,
                        max_shift: Optional[float] = None) -> torch.Tensor:
    """1-D bilinear resample of every row: ``out[b, h, j] = x[b, h, j + t[b, h]]``.

    PIL's edge rules (Geometry.c): a sample is inside iff its centre + 0.5
    lies in [0, W); an inside sample's two taps clamp to the border pixel; an
    outside sample takes the fill colour. ``max_shift`` bounds |t| as in the
    JAX package (the shift is clipped to it there; callers stay inside it)."""
    b, h, w, c = x.shape
    pad = w if max_shift is None else min(int(math.ceil(max_shift)) + 1, w)
    x = x.to(torch.float32)
    cols = torch.arange(w, dtype=torch.float32, device=x.device)
    sx = t[..., None] + cols  # (B, H, W), from the unclipped shift
    inside = (sx + 0.5 >= 0.0) & (sx + 0.5 < w)
    t = torch.clamp(t, -(pad - 1.0), pad - 1.0)
    k = torch.floor(t)
    f = (t - k)[..., None, None]
    i0 = k.to(torch.int64)[..., None] + cols.to(torch.int64)  # (B, H, W)
    g0 = torch.gather(x, 2, i0.clamp(0, w - 1)[..., None].expand(b, h, w, c))
    g1 = torch.gather(x, 2, (i0 + 1).clamp(0, w - 1)[..., None].expand(b, h, w, c))
    out = (1.0 - f) * g0 + f * g1
    fill = torch.tensor(_FILL, dtype=torch.float32, device=x.device)
    return torch.where(inside[..., None], out, fill)


def _col_shift_bilinear(x: torch.Tensor, t: torch.Tensor,
                        max_shift: Optional[float] = None) -> torch.Tensor:
    """``out[b, i, j] = x[b, i + t[b, j], j]``."""
    return _row_shift_bilinear(x.transpose(1, 2), t, max_shift).transpose(1, 2)


def _centered(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2.0


def rotate(x: torch.Tensor, degrees) -> torch.Tensor:
    """(B, H, W, 3) with H == W, per-image degrees, counter-clockwise (PIL):
    exact quarter turns, then a Paeth three-shear factorization of the
    residual angle (|r| <= 45 degrees), the JAX package's decomposition."""
    h, w = x.shape[1], x.shape[2]
    x = x.to(torch.float32)
    degrees = -torch.as_tensor(degrees, dtype=torch.float32, device=x.device)
    q = torch.round(degrees / 90.0)
    r = torch.deg2rad(degrees - 90.0 * q)
    qm = torch.remainder(q, 4.0)[:, None, None, None]
    r90 = x.transpose(1, 2).flip(2)
    r180 = x.flip(1, 2)
    r270 = x.transpose(1, 2).flip(1)
    out = torch.where(qm == 1.0, r90, x)
    out = torch.where(qm == 2.0, r180, out)
    out = torch.where(qm == 3.0, r270, out)
    alpha = torch.tan(r / 2.0)
    beta = -torch.sin(r)
    ys, xs = _centered(h, x.device), _centered(w, x.device)
    ms_a = 0.4143 * (h - 1) / 2.0
    ms_b = 0.7072 * (w - 1) / 2.0
    out = _row_shift_bilinear(out, alpha[:, None] * ys, ms_a)
    out = _col_shift_bilinear(out, beta[:, None] * xs, ms_b)
    return _row_shift_bilinear(out, alpha[:, None] * ys, ms_a)


def shear(x: torch.Tensor, fx, fy, max_factor: float = 0.31) -> torch.Tensor:
    """PIL affine shear anchored at the top-left origin (timm's
    ``AFFINE, (1, f, 0, 0, 1, 0)``): row y samples column x + f*(y + 0.5);
    an x pass then a y pass."""
    h, w = x.shape[1], x.shape[2]
    fx = torch.as_tensor(fx, dtype=torch.float32, device=x.device)
    fy = torch.as_tensor(fy, dtype=torch.float32, device=x.device)
    rows = torch.arange(h, dtype=torch.float32, device=x.device) + 0.5
    cols = torch.arange(w, dtype=torch.float32, device=x.device) + 0.5
    out = _row_shift_bilinear(x, fx[:, None] * rows, max_factor * h)
    return _col_shift_bilinear(out, fy[:, None] * cols, max_factor * w)


def translate(x: torch.Tensor, tx, ty, max_frac: float = 0.46) -> torch.Tensor:
    """Per-image translation by a fraction of the size; an x then a y pass."""
    b, h, w = x.shape[:3]
    tx = torch.as_tensor(tx, dtype=torch.float32, device=x.device)
    ty = torch.as_tensor(ty, dtype=torch.float32, device=x.device)
    out = _row_shift_bilinear(x, (tx * w)[:, None].expand(b, h), max_frac * w)
    return _col_shift_bilinear(out, (ty * h)[:, None].expand(b, w), max_frac * h)


def random_resized_crop(
    generator: Optional[torch.Generator],
    images: torch.Tensor,
    out_size: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """torchvision RandomResizedCrop semantics, batched, bilinear resample:
    (B, H, W, 3) -> float32 (B, out, out, 3) in [0, 255].

    Four U[0, 1) draws per image, from ``generator`` or from ``uniforms``
    (4, B): the area as a share of the image in ``scale``, the log-uniform
    aspect in ``ratio``, and the box's x and y offsets. A box that does not
    fit is clamped to the image."""
    b, h, w = images.shape[:3]
    if uniforms is None:
        uniforms = torch.rand(4, b, generator=generator, device=images.device)
    u1, u2, u3, u4 = uniforms.to(images.device, torch.float32)
    area = h * w * (scale[0] + u1 * (scale[1] - scale[0]))
    log_lo, log_hi = math.log(ratio[0]), math.log(ratio[1])
    r = torch.exp(log_lo + u2 * (log_hi - log_lo))
    cw = torch.clamp(torch.sqrt(area * r), 1.0, float(w))
    ch = torch.clamp(torch.sqrt(area / r), 1.0, float(h))
    x0 = u3 * (w - cw)
    y0 = u4 * (h - ch)
    return resample_boxes(images, y0, y0 + ch, x0, x0 + cw, out_size)


def horizontal_flip(generator: Optional[torch.Generator], x: torch.Tensor, p: float = 0.5,
                    flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mirror each image with probability ``p``; ``flip`` (B,) bool injects the draw."""
    if flip is None:
        flip = _bernoulli(generator, x, x.shape[0], p)
    return torch.where(flip.to(x.device)[:, None, None, None], x.flip(2), x)


# --- pixel ops (PIL-compatible where exactness is possible) -------------------


def invert(x: torch.Tensor) -> torch.Tensor:
    return 255.0 - x


def solarize(x: torch.Tensor, thresh) -> torch.Tensor:
    return torch.where(x >= _per_image(thresh, x), 255.0 - x, x)


def solarize_add(x: torch.Tensor, add, thresh: float = 128.0) -> torch.Tensor:
    return torch.where(x < thresh, torch.clamp(x + _per_image(add, x), 0, 255), x)


def posterize(x: torch.Tensor, bits) -> torch.Tensor:
    """Keep ``bits`` significant bits per channel (PIL ImageOps.posterize)."""
    shift = torch.pow(2.0, 8.0 - _per_image(bits, x))
    return torch.floor(torch.clamp(x, 0, 255) / shift) * shift


def autocontrast(x: torch.Tensor) -> torch.Tensor:
    """Per-image, per-channel histogram stretch (PIL autocontrast, cutoff 0)."""
    mn = torch.amin(x, dim=(1, 2), keepdim=True)
    mx = torch.amax(x, dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(mx - mn, min=1e-6)
    out = (x - mn) * scale
    return torch.where(mx > mn, torch.clamp(out, 0, 255), x)


def equalize(x: torch.Tensor) -> torch.Tensor:
    """PIL ImageOps.equalize, per image and channel, on rounded uint8 values:
    a histogram per (image, channel) by one ``bincount``, PIL's integer
    step ``(pixels - count of the last non-empty bin) // 255``, and the LUT
    applied by a gather."""
    b, h, w, c = x.shape
    xi = torch.clamp(torch.round(x), 0, 255).to(torch.int64)
    plane = torch.arange(b * c, device=x.device).reshape(b, 1, 1, c) * 256
    hist = torch.bincount((xi + plane).reshape(-1), minlength=b * c * 256).reshape(b, c, 256)
    idx = torch.arange(256, device=x.device)
    last_nz = torch.argmax(torch.where(hist > 0, idx, -1), dim=-1)  # (B, C)
    last_count = torch.gather(hist, 2, last_nz[..., None])[..., 0]
    step = torch.div(h * w - last_count, 255, rounding_mode="floor")
    csum_excl = torch.cumsum(hist, dim=-1) - hist
    lut = torch.div(csum_excl + torch.div(step, 2, rounding_mode="floor")[..., None],
                    torch.clamp(step, min=1)[..., None], rounding_mode="floor")
    out = torch.clamp(lut, 0, 255).to(torch.float32).reshape(-1)[xi + plane]
    return torch.where(step[:, None, None, :] > 0, out, x)


def brightness(x: torch.Tensor, factor) -> torch.Tensor:
    return _blend(x, torch.zeros_like(x), _per_image(factor, x))


def contrast(x: torch.Tensor, factor) -> torch.Tensor:
    """PIL Contrast: blend with the mean of the grayscale image."""
    mean = _gray(x).mean(dim=(1, 2, 3), keepdim=True)
    return _blend(x, mean.expand_as(x), _per_image(factor, x))


def saturation(x: torch.Tensor, factor) -> torch.Tensor:
    """PIL Color: blend with the grayscale image."""
    return _blend(x, _gray(x).expand_as(x), _per_image(factor, x))


def sharpness(x: torch.Tensor, factor) -> torch.Tensor:
    """PIL Sharpness: blend with the SMOOTH-filtered image; PIL leaves the
    1-pixel border unsmoothed."""
    c = x.shape[-1]
    kernel = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                          device=x.device) / 13.0
    sm = F.conv2d(x.permute(0, 3, 1, 2), kernel.expand(c, 1, 3, 3), padding=1, groups=c)
    sm = sm.permute(0, 2, 3, 1)
    interior = torch.zeros(x.shape[1:3] + (1,), dtype=torch.bool, device=x.device)
    interior[1:-1, 1:-1] = True
    return _blend(x, torch.where(interior, sm, x), _per_image(factor, x))


def grayscale(x: torch.Tensor) -> torch.Tensor:
    return torch.round(_gray(x)).expand_as(x)


def gaussian_blur(generator: Optional[torch.Generator], x: torch.Tensor, p: float = 0.5,
                  radius_min: float = 0.1, radius_max: float = 2.0,
                  apply: Optional[torch.Tensor] = None,
                  sigma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-image gaussian blur (9 taps, edge padding, separable: rows then
    columns) with sigma ~ U[radius_min, radius_max), applied with
    probability ``p``. One grouped conv per axis, a kernel per image."""
    b, h, w, c = x.shape
    if apply is None:
        apply = _bernoulli(generator, x, b, p)
    if sigma is None:
        sigma = _uniform(generator, x, b, radius_min, radius_max)
    sigma = sigma.to(x.device, torch.float32)
    offsets = torch.arange(-4, 5, dtype=torch.float32, device=x.device)
    wts = torch.exp(-(offsets[None, :] ** 2) / (2.0 * sigma[:, None] ** 2))
    wts = (wts / wts.sum(dim=1, keepdim=True)).repeat_interleave(c, dim=0)  # (B*C, 9)
    planes = x.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    planes = F.conv2d(F.pad(planes, (0, 0, 4, 4), mode="replicate"),
                      wts[:, None, :, None], groups=b * c)
    planes = F.conv2d(F.pad(planes, (4, 4, 0, 0), mode="replicate"),
                      wts[:, None, None, :], groups=b * c)
    blurred = planes.reshape(b, c, h, w).permute(0, 2, 3, 1)
    return torch.where(apply.to(x.device)[:, None, None, None], blurred, x)


def random_grayscale(generator: Optional[torch.Generator], x: torch.Tensor, p: float = 0.2,
                     apply: Optional[torch.Tensor] = None) -> torch.Tensor:
    if apply is None:
        apply = _bernoulli(generator, x, x.shape[0], p)
    return torch.where(apply.to(x.device)[:, None, None, None], grayscale(x), x)


def random_solarize(generator: Optional[torch.Generator], x: torch.Tensor, p: float = 0.5,
                    thresh: float = 128.0,
                    apply: Optional[torch.Tensor] = None) -> torch.Tensor:
    if apply is None:
        apply = _bernoulli(generator, x, x.shape[0], p)
    return torch.where(apply.to(x.device)[:, None, None, None], solarize(x, thresh), x)


_JITTER_ORDERS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def color_jitter(generator: Optional[torch.Generator], x: torch.Tensor, b: float = 0.4,
                 c: float = 0.4, s: float = 0.4, factors: Optional[torch.Tensor] = None,
                 order: Optional[int] = None) -> torch.Tensor:
    """torchvision ColorJitter(brightness, contrast, saturation): per-image
    factors in [1 - v, 1 + v] (``factors`` (3, B) injects them), applied in
    one of the 6 orders for the whole batch (``order`` injects its index)."""
    n = x.shape[0]
    if factors is None:
        factors = torch.stack([_uniform(generator, x, n, 1 - v, 1 + v) for v in (b, c, s)])
    if order is None:
        order = host_choice(generator, len(_JITTER_ORDERS), 1)
    fns = (brightness, contrast, saturation)
    for i in _JITTER_ORDERS[int(order)]:
        x = fns[i](x, factors[i])
    return x


def random_erasing(
    generator: Optional[torch.Generator],
    x_norm: torch.Tensor,
    p: float = 0.25,
    area: Tuple[float, float] = (0.02, 1.0 / 3.0),
    ratio_min: float = 0.3,
    apply: Optional[torch.Tensor] = None,
    target: Optional[torch.Tensor] = None,
    log_r: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """timm RandomErasing 'pixel' mode on the NORMALIZED tensor: with
    probability ``p`` a rectangle of area ``target`` (a share in ``area`` of
    the image) and log aspect ``log_r`` is filled with N(0, 1) ``noise``;
    ``offsets`` (2, B) are the U[0, 1) draws that place it (y, x)."""
    b, h, w, _ = x_norm.shape
    if apply is None:
        apply = _bernoulli(generator, x_norm, b, p)
    if target is None:
        target = _uniform(generator, x_norm, b, area[0], area[1]) * h * w
    if log_r is None:
        log_r = _uniform(generator, x_norm, b, math.log(ratio_min), math.log(1.0 / ratio_min))
    if offsets is None:
        offsets = _rand(generator, x_norm, 2, b)
    if noise is None:
        noise = torch.randn(x_norm.shape, generator=generator, device=x_norm.device)
    dev = x_norm.device
    r = torch.exp(log_r.to(dev))
    eh = torch.clamp(torch.round(torch.sqrt(target.to(dev) * r)), 1, h - 1)
    ew = torch.clamp(torch.round(torch.sqrt(target.to(dev) / r)), 1, w - 1)
    offsets = offsets.to(dev)
    y0 = (offsets[0] * (h - eh)).to(torch.int64)
    x0 = (offsets[1] * (w - ew)).to(torch.int64)
    gy = torch.arange(h, device=dev)[None, :, None]
    gx = torch.arange(w, device=dev)[None, None, :]
    inside = ((gy >= y0[:, None, None]) & (gy < (y0 + eh.to(torch.int64))[:, None, None])
              & (gx >= x0[:, None, None]) & (gx < (x0 + ew.to(torch.int64))[:, None, None]))
    mask = (inside & apply.to(dev)[:, None, None])[..., None]
    return torch.where(mask, noise.to(dev, x_norm.dtype), x_norm)


# --- RandAugment ---------------------------------------------------------------

# the 'inc1' increasing-severity op set of timm rand-m9-mstd0.5-inc1
RA_OPS = (
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness",
    "ShearX", "ShearY", "TranslateX", "TranslateY",
)


def ra_apply(op: int, x: torch.Tensor, mag: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """One RandAugment op on the whole batch, per-image magnitude and sign."""
    frac = mag / 10.0
    zero = torch.zeros_like(sign)
    name = RA_OPS[int(op)]
    if name == "AutoContrast":
        return autocontrast(x)
    if name == "Equalize":
        return equalize(x)
    if name == "Invert":
        return invert(x)
    if name == "Rotate":
        return rotate(x, sign * 30.0 * frac)
    if name == "Posterize":  # keeps 4 - int(4 * frac) bits: severity rises with magnitude
        return posterize(x, 4.0 - torch.floor(4.0 * frac))
    if name == "Solarize":
        return solarize(x, 256.0 - torch.floor(256.0 * frac))
    if name == "SolarizeAdd":
        return solarize_add(x, torch.floor(110.0 * frac))
    enhance = 1.0 + sign * 0.9 * frac
    if name == "Color":
        return saturation(x, enhance)
    if name == "Contrast":
        return contrast(x, enhance)
    if name == "Brightness":
        return brightness(x, enhance)
    if name == "Sharpness":
        return sharpness(x, enhance)
    if name == "ShearX":
        return shear(x, sign * 0.3 * frac, zero)
    if name == "ShearY":
        return shear(x, zero, sign * 0.3 * frac)
    if name == "TranslateX":
        return translate(x, sign * 0.45 * frac, zero)
    return translate(x, zero, sign * 0.45 * frac)


def rand_augment(
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    num_ops: int = 2,
    magnitude: float = 9.0,
    mstd: float = 0.5,
    op_prob: float = 0.5,
    layers: Optional[Sequence[Dict[str, object]]] = None,
) -> torch.Tensor:
    """timm ``rand-m9-mstd0.5-inc1``: ``num_ops`` layers, each one op for the
    whole batch (as in the JAX package), a magnitude ~ N(magnitude, mstd)
    clipped to [0, 10], a sign and an apply-with-``op_prob`` per image.
    ``layers`` injects the draws: one dict per layer with ``op`` (int),
    ``mag`` (B,), ``sign`` (B,) of +-1 and ``apply`` (B,) bool; a missing key
    is drawn."""
    b = x.shape[0]
    for layer in range(num_ops):
        d = dict(layers[layer]) if layers is not None else {}
        op = d.get("op")
        if op is None:
            op = host_choice(generator, len(RA_OPS), 0, layer)
        mag = d.get("mag")
        if mag is None:
            mag = torch.clamp(magnitude + mstd * torch.randn(
                b, generator=generator, device=x.device), 0.0, 10.0)
        sign = d.get("sign")
        if sign is None:
            sign = torch.where(_bernoulli(generator, x, b, 0.5), 1.0, -1.0)
        apply = d.get("apply")
        if apply is None:
            apply = _bernoulli(generator, x, b, op_prob)
        out = ra_apply(op, x, mag.to(x.device), sign.to(x.device))
        x = torch.where(apply.to(x.device)[:, None, None, None], out, x)
    return x


# --- composed pipelines ---------------------------------------------------------


def weak_augment(generator: Optional[torch.Generator], images_u8: torch.Tensor,
                 out_size: int = 80, randaug_p: float = 0.2,
                 draws: Draws = None) -> torch.Tensor:
    """The reference's ``build_transform_weak``: random resized crop, flip,
    RandAugment with probability ``randaug_p``; float [0, 255]. ``draws``:
    ``crop`` (the (4, B) uniforms), ``flip``, ``randaug`` (B,) bool and
    ``layers`` (see ``rand_augment``)."""
    d = draws or {}
    x = random_resized_crop(generator, images_u8, out_size, uniforms=d.get("crop"))
    x = horizontal_flip(generator, x, flip=d.get("flip"))
    do_ra = d.get("randaug")
    if do_ra is None:
        do_ra = _bernoulli(generator, x, x.shape[0], randaug_p)
    x_ra = rand_augment(generator, x, layers=d.get("layers"))
    return torch.where(do_ra.to(x.device)[:, None, None, None], x_ra, x)


def strong_from_weak(generator: Optional[torch.Generator], weak: torch.Tensor,
                     strong_prob: float = 0.5, draws: Draws = None) -> torch.Tensor:
    """The reference's strong view, derived from the WEAK view so the two stay
    spatially aligned: with probability ``strong_prob`` ColorJitter, blur,
    solarize and grayscale. ``draws``: ``jitter`` (kwargs of
    ``color_jitter``), ``blur`` (of ``gaussian_blur``), ``solarize`` and
    ``gray`` (B,) bool, ``strong`` (B,) bool."""
    d = draws or {}
    x = color_jitter(generator, weak, **dict(d.get("jitter") or {}))
    x = gaussian_blur(generator, x, p=0.5, **dict(d.get("blur") or {}))
    x = random_solarize(generator, x, p=0.5, apply=d.get("solarize"))
    x = random_grayscale(generator, x, p=0.2, apply=d.get("gray"))
    apply = d.get("strong")
    if apply is None:
        apply = _bernoulli(generator, weak, weak.shape[0], strong_prob)
    return torch.where(apply.to(weak.device)[:, None, None, None], x, weak)


def make_dual_view_fn(mean=MEAN, std=STD, out_size: int = 80, strong_prob: float = 0.5,
                      erase_p: float = 0.25) -> Callable:
    """``fn(images_u8, generator=None, draws=None) -> (strong, weak)``, both
    normalized, for SUN: ONE crop; the weak view is crop + flip +
    RandAugment(p 0.2); the strong view is derived from the weak one, then
    erased. ``draws``: ``weak`` (of ``weak_augment``), ``strong`` (of
    ``strong_from_weak``), ``erase`` (kwargs of ``random_erasing``)."""

    def fn(images_u8: torch.Tensor, generator: Optional[torch.Generator] = None,
           draws: Draws = None) -> Tuple[torch.Tensor, torch.Tensor]:
        d = draws or {}
        weak = weak_augment(generator, images_u8, out_size, draws=d.get("weak"))
        strong = strong_from_weak(generator, weak, strong_prob, draws=d.get("strong"))
        strong_n = random_erasing(generator, normalize(strong, mean, std), p=erase_p,
                                  **dict(d.get("erase") or {}))
        return strong_n, normalize(weak, mean, std)

    return fn


def make_cropaug_fn(mean=MEAN, std=STD, out_size: int = 80, erase_p: float = 0.25) -> Callable:
    """``fn(images_u8, generator=None, draws=None) -> normalized``: timm
    ``create_transform(..., auto_augment='rand-m9-mstd0.5-inc1', re_prob=0.25)``
    (phase-1 'cropaug'): random resized crop, flip, RandAugment (always),
    normalize, random erasing. ``draws``: ``crop``, ``flip``, ``layers``,
    ``erase``."""

    def fn(images_u8: torch.Tensor, generator: Optional[torch.Generator] = None,
           draws: Draws = None) -> torch.Tensor:
        d = draws or {}
        x = random_resized_crop(generator, images_u8, out_size, uniforms=d.get("crop"))
        x = horizontal_flip(generator, x, flip=d.get("flip"))
        x = rand_augment(generator, x, layers=d.get("layers"))
        return random_erasing(generator, normalize(x, mean, std), p=erase_p,
                              **dict(d.get("erase") or {}))

    return fn

