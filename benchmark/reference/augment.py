"""Plain PyTorch reference of SUN's location-aware dual view, written from
the reference training recipe (timm ``rand-m9-mstd0.5-inc1``, torchvision
``RandomResizedCrop`` / ``ColorJitter``, PIL's pixel and affine operations,
timm ``RandomErasing`` in pixel mode), every random draw given explicitly.

Images are float64 (B, H, W, 3) in [0, 255]. ``dual_view(images_u8, draws,
mean, std, out)`` -> (strong, weak), both normalized; ``draws`` is the dict
the measured program takes as ``draws=``:

  * ``weak``: ``crop`` (4, B) uniforms (area share, log aspect, x and y
    offset), ``flip`` (B,), ``randaug`` (B,) and ``layers``: two dicts of
    ``op`` (int), ``mag``, ``sign`` and ``apply`` (B,);
  * ``strong``: ``jitter`` {``factors`` (3, B), ``order``}, ``blur``
    {``apply``, ``sigma``}, ``solarize``, ``gray`` and ``strong`` (B,);
  * ``erase``: ``apply``, ``target`` (area in pixels), ``log_r``,
    ``offsets`` (2, B) and ``noise`` (B, H, W, 3).

Affine operations resample each row (or column) at a constant offset:
bilinear between the two nearest pixels clamped to the border, PIL's
inside test (sample centre + 0.5 in [0, size)), the timm fill colour
outside; a rotation is three such shears (Paeth).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LUMA = (0.299, 0.587, 0.114)
FILL = (124.0, 116.0, 104.0)
OPS = ("AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
       "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness",
       "ShearX", "ShearY", "TranslateX", "TranslateY")
JITTER_ORDERS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def _b(v: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1)."""
    return v.reshape(-1, 1, 1, 1)


def triangle_weights(in_size: int, out: int, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(B, out, in) float64 weights resampling the spans [lo, hi) of an axis
    of ``in_size`` pixels onto ``out`` pixels: output centre i maps to
    lo + (i + 0.5) * (hi - lo) / out - 0.5; a triangle kernel widened by the
    shrink factor when the span shrinks; rows normalized; samples outside
    the image are 0."""
    lo, hi = lo.double()[:, None, None], hi.double()[:, None, None]
    step = (hi - lo) / out
    width = torch.clamp(step, min=1.0)
    centre = lo + (torch.arange(out, dtype=torch.float64, device=lo.device)[:, None] + 0.5) * step - 0.5
    taps = torch.arange(in_size, dtype=torch.float64, device=lo.device)
    w = torch.clamp(1.0 - (centre - taps).abs() / width, min=0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total > 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (centre >= -0.5) & (centre <= in_size - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def resized_crop(images: torch.Tensor, u: torch.Tensor, out: int) -> torch.Tensor:
    """torchvision RandomResizedCrop (scale 0.08-1, ratio 3/4-4/3), the box
    clamped to the image, from the uniforms ``u`` (4, B)."""
    b, h, w = images.shape[:3]
    u = u.double()
    area = h * w * (0.08 + u[0] * (1.0 - 0.08))
    ratio = torch.exp(math.log(3 / 4) + u[1] * (math.log(4 / 3) - math.log(3 / 4)))
    cw = torch.clamp(torch.sqrt(area * ratio), 1.0, float(w))
    ch = torch.clamp(torch.sqrt(area / ratio), 1.0, float(h))
    x0, y0 = u[2] * (w - cw), u[3] * (h - ch)
    wy = triangle_weights(h, out, y0, y0 + ch)
    wx = triangle_weights(w, out, x0, x0 + cw)
    return torch.einsum("byh,bhwc,bxw->byxc", wy, images.double(), wx)


def shift_rows(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out[b, h, j] = x[b, h, j + t[b, h]], bilinear, taps clamped to the
    border; a sample whose centre + 0.5 falls outside [0, W) is the fill."""
    b, h, w, c = x.shape
    cols = torch.arange(w, dtype=torch.float64, device=x.device)
    s = t.double()[..., None] + cols                             # (B, H, W)
    k = torch.floor(s)
    f = (s - k)[..., None]
    i0 = k.long().clamp(0, w - 1)
    i1 = (k.long() + 1).clamp(0, w - 1)
    g = lambda i: torch.gather(x, 2, i[..., None].expand(b, h, w, c))
    out = (1.0 - f) * g(i0) + f * g(i1)
    inside = ((s + 0.5 >= 0) & (s + 0.5 < w))[..., None]
    return torch.where(inside, out, torch.tensor(FILL, dtype=x.dtype, device=x.device))


def shift_cols(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out[b, i, j] = x[b, i + t[b, j], j]."""
    return shift_rows(x.transpose(1, 2), t).transpose(1, 2)


def rotate(x: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """Counter-clockwise by ``degrees`` (|degrees| < 45) about the centre:
    x-shear by tan(r/2), y-shear by -sin(r), x-shear by tan(r/2), r the
    clockwise angle in radians."""
    h, w = x.shape[1:3]
    r = torch.deg2rad(-degrees.double())
    ys = torch.arange(h, dtype=torch.float64, device=x.device) - (h - 1) / 2
    xs = torch.arange(w, dtype=torch.float64, device=x.device) - (w - 1) / 2
    alpha, beta = torch.tan(r / 2)[:, None], -torch.sin(r)[:, None]
    x = shift_rows(x, alpha * ys)
    x = shift_cols(x, beta * xs)
    return shift_rows(x, alpha * ys)


def gray(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0:1] * LUMA[0] + x[..., 1:2] * LUMA[1] + x[..., 2:3] * LUMA[2]


def blend(a, b, f):
    """PIL ImageEnhance: b + f (a - b), clipped to [0, 255]."""
    return torch.clamp(b + _b(f) * (a - b), 0.0, 255.0)


def equalize(x: torch.Tensor) -> torch.Tensor:
    """PIL ImageOps.equalize per image and channel on the rounded values:
    step = (pixels - count of the last non-empty bin) // 255; lut[v] =
    (pixels below v + step // 2) // step; unchanged where step is 0."""
    b, h, w, c = x.shape
    v = torch.clamp(torch.round(x), 0, 255).long()
    out = x.clone()
    for i in range(b):
        for ch in range(c):
            hist = torch.bincount(v[i, ..., ch].reshape(-1), minlength=256)
            last = int(torch.nonzero(hist).max())
            step = (h * w - int(hist[last])) // 255
            if step == 0:
                continue
            below = torch.cumsum(hist, 0) - hist
            lut = torch.clamp((below + step // 2) // step, max=255).double()
            out[i, ..., ch] = lut[v[i, ..., ch]]
    return out


def sharpness(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """PIL Sharpness: blend with the 3x3 SMOOTH filter ([1 1 1; 1 5 1; 1 1
    1] / 13), the one-pixel border left unsmoothed."""
    k = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                     dtype=x.dtype, device=x.device) / 13.0
    c = x.shape[-1]
    sm = F.conv2d(x.permute(0, 3, 1, 2), k.expand(c, 1, 3, 3), padding=1, groups=c)
    sm = sm.permute(0, 2, 3, 1).clone()
    sm[:, 0], sm[:, -1], sm[:, :, 0], sm[:, :, -1] = x[:, 0], x[:, -1], x[:, :, 0], x[:, :, -1]
    return blend(x, sm, f)


def rand_augment_op(op: int, x: torch.Tensor, mag: torch.Tensor, sign: torch.Tensor):
    """One op of timm's increasing-severity set at magnitude ``mag`` (0-10)."""
    frac = mag.double() / 10.0
    sign = sign.double()
    h, w = x.shape[1:3]
    name = OPS[int(op)]
    if name == "AutoContrast":
        lo = x.amin(dim=(1, 2), keepdim=True)
        hi = x.amax(dim=(1, 2), keepdim=True)
        out = torch.clamp((x - lo) * 255.0 / torch.clamp(hi - lo, min=1e-6), 0, 255)
        return torch.where(hi > lo, out, x)
    if name == "Equalize":
        return equalize(x)
    if name == "Invert":
        return 255.0 - x
    if name == "Rotate":
        return rotate(x, sign * 30.0 * frac)
    if name == "Posterize":
        shift = _b(2.0 ** (8.0 - (4.0 - torch.floor(4.0 * frac))))
        return torch.floor(torch.clamp(x, 0, 255) / shift) * shift
    if name == "Solarize":
        return torch.where(x >= _b(256.0 - torch.floor(256.0 * frac)), 255.0 - x, x)
    if name == "SolarizeAdd":
        return torch.where(x < 128.0, torch.clamp(x + _b(torch.floor(110.0 * frac)), 0, 255), x)
    factor = 1.0 + sign * 0.9 * frac
    if name == "Color":
        return blend(x, gray(x).expand_as(x), factor)
    if name == "Contrast":
        return blend(x, gray(x).mean(dim=(1, 2, 3), keepdim=True).expand_as(x), factor)
    if name == "Brightness":
        return blend(x, torch.zeros_like(x), factor)
    if name == "Sharpness":
        return sharpness(x, factor)
    rows = torch.arange(h, dtype=torch.float64, device=x.device) + 0.5
    cols = torch.arange(w, dtype=torch.float64, device=x.device) + 0.5
    if name == "ShearX":
        return shift_rows(x, (sign * 0.3 * frac)[:, None] * rows)
    if name == "ShearY":
        return shift_cols(x, (sign * 0.3 * frac)[:, None] * cols)
    if name == "TranslateX":
        return shift_rows(x, (sign * 0.45 * frac * w)[:, None].expand(-1, h))
    return shift_cols(x, (sign * 0.45 * frac * h)[:, None].expand(-1, w))


def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """9 taps (offsets -4..4) of exp(-o^2 / 2 sigma^2), normalized, edges
    replicated; rows then columns."""
    b, h, w, c = x.shape
    o = torch.arange(-4, 5, dtype=torch.float64, device=x.device)
    k = torch.exp(-o[None] ** 2 / (2.0 * sigma.double()[:, None] ** 2))
    k = k / k.sum(1, keepdim=True)
    p = F.pad(x.permute(0, 3, 1, 2), (4, 4, 4, 4), mode="replicate")   # (B, C, H+8, W+8)
    rows = sum(k[:, i, None, None, None] * p[:, :, i:i + h, :] for i in range(9))
    out = sum(k[:, i, None, None, None] * rows[:, :, :, i:i + w] for i in range(9))
    return out.permute(0, 2, 3, 1)


def weak_view(images_u8: torch.Tensor, d: dict, out: int) -> torch.Tensor:
    x = resized_crop(images_u8, d["crop"], out)
    x = torch.where(_b(d["flip"]), x.flip(2), x)
    ra = x
    for layer in d["layers"]:
        y = rand_augment_op(layer["op"], ra, layer["mag"], layer["sign"])
        ra = torch.where(_b(layer["apply"]), y, ra)
    return torch.where(_b(d["randaug"]), ra, x)


def strong_view(weak: torch.Tensor, d: dict) -> torch.Tensor:
    x = weak
    fns = (lambda t, f: blend(t, torch.zeros_like(t), f),
           lambda t, f: blend(t, gray(t).mean(dim=(1, 2, 3), keepdim=True).expand_as(t), f),
           lambda t, f: blend(t, gray(t).expand_as(t), f))
    factors = d["jitter"]["factors"].double()
    for i in JITTER_ORDERS[int(d["jitter"]["order"])]:
        x = fns[i](x, factors[i])
    x = torch.where(_b(d["blur"]["apply"]), gaussian_blur(x, d["blur"]["sigma"]), x)
    x = torch.where(_b(d["solarize"]), torch.where(x >= 128.0, 255.0 - x, x), x)
    x = torch.where(_b(d["gray"]), torch.round(gray(x)).expand_as(x), x)
    return torch.where(_b(d["strong"]), x, weak)


def erase(x: torch.Tensor, d: dict) -> torch.Tensor:
    """timm RandomErasing, pixel mode, on the normalized images."""
    b, h, w, _ = x.shape
    r = torch.exp(d["log_r"].double())
    target = d["target"].double()
    eh = torch.clamp(torch.round(torch.sqrt(target * r)), 1, h - 1)
    ew = torch.clamp(torch.round(torch.sqrt(target / r)), 1, w - 1)
    y0 = (d["offsets"][0].double() * (h - eh)).long()
    x0 = (d["offsets"][1].double() * (w - ew)).long()
    gy = torch.arange(h, device=x.device)[None, :, None]
    gx = torch.arange(w, device=x.device)[None, None, :]
    box = ((gy >= y0[:, None, None]) & (gy < (y0 + eh.long())[:, None, None])
           & (gx >= x0[:, None, None]) & (gx < (x0 + ew.long())[:, None, None]))
    box = (box & d["apply"].reshape(-1, 1, 1))[..., None]
    return torch.where(box, d["noise"].to(x.dtype), x)


def dual_view(images_u8: torch.Tensor, draws: dict, mean, std, out: int):
    """-> (strong, weak), normalized, float64."""
    m = torch.as_tensor(mean, dtype=torch.float64, device=images_u8.device)
    s = torch.as_tensor(std, dtype=torch.float64, device=images_u8.device)
    norm = lambda t: (t / 255.0 - m) / s
    weak = weak_view(images_u8, draws["weak"], out)
    strong = strong_view(weak, draws["strong"])
    return erase(norm(strong), draws["erase"]), norm(weak)
