"""Check and time the hand-written kernels alone on one card, route against route.

    python -m fewshot_vit_tpu_torch.kernels.bench [--reps 20] [--ptxas]
        [--only sinkhorn|window|layer_norm|block] [--against OTHER/sinkhorn.cu ...]

Builds ``csrc/*.cu``, prints what ``ptxas -v`` says of every kernel (registers,
spills, shared memory), holds each route of ``fused_mhsa`` and
``sinkhorn_pallas`` against its plain version (the bare launch with the
output pre-filled with NaN, and the custom op beside it), and times them in
turns (route by route, then back) with CUDA events,
``scaled_dot_product_attention`` and the plain version beside the MHSA as
yardsticks. The MHSA runs at the shapes its callers give it (``MHSA_TIMED``)
and is checked at the routes' edges (``MHSA_EDGES``). The Sinkhorn's general
route is checked and timed at its callers' shapes (``SINKHORN_GENERAL``)
beside its plain version; ``--against`` builds another
``sinkhorn.cu`` with the same C interface (an earlier tree's, a variant) into
a library of its own and times its general route in turns with this one's,
bare launches both, at the shapes it takes. Swin's window attention
(``window_attention``) is checked against its plain version at every Swin-T
stage, shifted and not, and timed at those stages for a 2,560-image batch
(``WINDOW_STAGES``): the bare launch beside its bytes-or-flops bound, and a
block's whole span (qkv, attention, proj) on the kernel and on the einsum
path. The LayerNorm kernel (``layer_norm``) is checked against its plain
version at Swin-T's widths and at widths that reach every compiled vector
count and the masked tail (``LAYER_NORM_CHECK_WIDTHS``), at row counts of 1,
7 and a ragged tail, and timed at Swin-T's LayerNorm shapes for a 2,560-image batch
(``LAYER_NORM_SHAPES``): the bare launch beside its bytes bound, the plain
version (fp32 LayerNorm between two casts), and ``F.layer_norm`` on the bf16
tensor with bf16 weights, the library's yardstick, which the port never
calls. NesT's block attention (``block_attention``) is checked against its
plain version at NesT-T's three levels and at the 80 px NesTs' blocks of 25
and 100 tokens (``BLOCK_SHAPES``), and timed there for a 2,560-image batch:
the bare launch beside its bytes-or-flops bound, the plain version,
``scaled_dot_product_attention`` on the same q, k, v views (the library's
yardstick, never called by the port), and a layer's whole span (qkv,
attention, proj) on the kernel and on the einsum path, in turns (the
evidence in ``kernels.block.kernel_takes``). The check holds each output
element within 1e-2 + 2^-6 |want| and the whole output's relative rms gap
within ``BLOCK_REL_RMS``.
``--only`` builds, checks and times one kernel alone. Every line names the
card and its power limit.

Two speed gates: the packed Sinkhorn route must beat the general route at a
SUN-D eval batch of 3,000 problems of 13 and of 25 nodes, and the tensor-core
MHSA route must beat ``scaled_dot_product_attention`` and the general route
at the SUN-M eval's stage 2, (10240, 6, 100, 42) in bf16. The exit status is
non-zero when a check fails or a route loses its gate. ``chip_smoke.py``
checks the kernels on their callers' paths and takes no kernel time: the
kernels' times are this module's.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ..core.watchdog import watchdog_reexec
from . import build
from . import attention, sinkhorn
from .attention import fused_mhsa, fused_mhsa_reference
from .sinkhorn import sinkhorn_pallas, sinkhorn_reference
from . import block as ba
from . import layer_norm as ln
from . import window as wa

F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: 1e-4, BF16: 2e-2}
# (batch, heads, tokens, hd, dtypes): the SUN-M eval's stage 2 (128 episodes
# of 80 images), the SUN teacher's batch of 512, the eval CLI's batch of 8
# episodes, visformer_small's stage 3 at 224 px at the eval CLI's batch and
# at 20 times it (enough work that the launch's host time does not hide the
# device's)
MHSA_TIMED = ((10240, 6, 100, 42, (BF16, F32)), (512, 6, 100, 42, (F32, BF16)),
              (640, 6, 100, 42, (F32,)), (32, 6, 196, 128, (BF16, F32)),
              (640, 6, 196, 128, (BF16, F32)))
# (batch, n1, n2): a SUN-D batch of 8 episodes and a training episode with a
# feature pyramid (38 nodes), the old general route's limit, visformer_small's
# 14 x 14 map (196), and ragged and limit cases
SINKHORN_GENERAL = ((3000, 38, 38), (375, 38, 38), (3000, 64, 64), (3000, 196, 196),
                    (7, 38, 25), (5, 209, 150), (4, sinkhorn.MAX_NODES, sinkhorn.MAX_NODES))
SINKHORN_TIMED_GENERAL = 4  # the first four are timed
# Swin-T's stages at 224 px, window 7: (grid, channels, heads, shift of the
# odd blocks); the last stage is one window, unshifted. Timed at the Swin
# cell's batch of 2,560 images, checked at WINDOW_CHECK_BATCH.
WINDOW_STAGES = ((56, 96, 3, 3), (28, 192, 6, 3), (14, 384, 12, 3), (7, 768, 24, 0))
WINDOW_BATCH, WINDOW_CHECK_BATCH = 2560, 8
# Swin-T's LayerNorms at 224 px for a 2,560-image batch: (rows, width) of
# stage 1's norms (and the patch embedding's), merge 1's, stage 2's, merge
# 2's, stage 3's, merge 3's, stage 4's (and the final norm)
LAYER_NORM_SHAPES = ((8028160, 96), (2007040, 384), (2007040, 192), (501760, 768),
                     (501760, 384), (125440, 1536), (125440, 768))
# checked at LAYER_NORM_CHECK_ROWS rows: Swin-T's widths (16-byte vectors a
# lane V = 3, or 6 at 1,536) and widths that reach every other compiled V
# (8: 1, 16: 2, 64: 4, 144 and 272: 5, 1,600: 7, 1,800 and 2,048: 8) and
# the masked tail, a row's vectors no whole multiple of its lanes (144, 272,
# 576, 1,152, 1,600, 1,800; the zoo's Swins run 144, 576 and 1,152)
LAYER_NORM_CHECK_WIDTHS = (8, 16, 64, 96, 144, 192, 272, 384, 576, 768, 1152, 1536, 1600, 1800,
                           2048)
LAYER_NORM_CHECK_ROWS = (1, 7, 4099)
# NesT's block attention, hd 32: (blocks an image, tokens, channels, heads) of
# NesT-T's three levels at 224 px, then nest_micro_80's level 1 (25 tokens)
# and nest_micro_resembed_2x_80's last level (100 tokens); timed at
# BLOCK_IMAGES images, checked at BLOCK_CHECK_IMAGES, the plain version
# timed over the batch in chunks of BLOCK_PLAIN_IMAGES
BLOCK_SHAPES = ((16, 196, 96, 3), (4, 196, 192, 6), (1, 196, 384, 12), (16, 25, 128, 4),
                (1, 100, 512, 16))
BLOCK_IMAGES, BLOCK_CHECK_IMAGES, BLOCK_PLAIN_IMAGES = 2560, 8, 320
BLOCK_ATOL, BLOCK_RTOL = 1e-2, 2.0 ** -6
# the block kernel's relative rms gap to its plain version (block_rel_rms).
# On an H100, at BLOCK_SHAPES with q,k at std 1 and 2, the kernel read
# 2.0e-5 to 8.0e-5; the same source with the padded-key mask removed read
# 1.25e-2 at 196 tokens (every output about 1.2% off, inside the elementwise
# rule), 2.38e-2 at 100 and 0.149 at 25 with q,k at std 1, and 7.0e-4 to
# 1.2e-3 at std 2, where the softmax is peaked
BLOCK_REL_RMS = 5e-4
# the speed gates (see the module's docstring)
MHSA_GATE = (10240, 6, 100, 42, BF16)
SINKHORN_GATE_BATCH = 3000
MHSA_EDGES = ((64, 4, 512, 128), (4, 2, 129, 64), (4, 2, 128, 128), (32, 6, 25, 85),
              (2, 3, 33, 97), (3, 1, 1, 1), (8, 4, 64, 48))


def time_ms(fn, reps: int, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _against(src: str, tag: str):
    """``sinkhorn_forward`` of another source file, built with this tree's
    flags into a library of its own; a launch on its general route, which
    raises where that source refuses the shape."""
    import ctypes
    import os

    out = build.BUILD_DIR / f"libsinkhorn_against{tag}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    for line in build.ptxas_summary(proc.stdout + proc.stderr):
        print(f"  ptxas {src}: {line}")
    fn = ctypes.CDLL(os.path.abspath(out)).sinkhorn_forward
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(cost, w1, w2, out):
        b, n1, n2 = cost.shape
        err = fn(cost.device.index, 0, cost.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                 out.data_ptr(), b, n1, n2, 0.05, 100,
                 torch.cuda.current_stream(cost.device).cuda_stream)
        if err:
            raise RuntimeError(f"{src} refused ({b},{n1},{n2}): cudaError {err}")

    return launch


def _sinkhorn_general(card, gen, dev, reps, others):
    """The general route at its callers' shapes: the bare launch into a
    NaN-filled output and the op against the plain version (1e-4, and 1e-3
    of the plain flow's largest entry), then the bare launch timed in turns
    with each other source's where it takes the shape, beside the plain
    version."""
    from ..ops.emd import normalize_weights

    ok = True
    for k, (bsz, n1, n2) in enumerate(SINKHORN_GENERAL):
        cost = 2.0 * torch.rand(bsz, n1, n2, generator=gen, device=dev)
        w1 = normalize_weights(torch.rand(bsz, n1, generator=gen, device=dev))
        w2 = normalize_weights(torch.rand(bsz, n2, generator=gen, device=dev))
        want = sinkhorn_reference(cost, w1, w2)
        out = torch.full_like(cost, float("nan"))
        sinkhorn._launch(cost, w1, w2, out, 0.05, 100, "general")
        got = sinkhorn_pallas(cost, w1, w2, route="general")
        torch.cuda.synchronize()
        err = max((o - want).abs().max().nan_to_num(float("inf")).item() for o in (out, got))
        scale = want.abs().max().item()
        good = err <= 1e-4 and err <= 1e-3 * scale
        ok &= good
        print(f"[{card}] sinkhorn_pallas general ({bsz},{n1},{n2}): max|d|={err:.3e}, "
              f"1e-3 of max flow {1e-3 * scale:.3e}{'' if good else '  FAIL'}")
        if k >= SINKHORN_TIMED_GENERAL:
            continue
        fns = {"this": lambda: sinkhorn._launch(cost, w1, w2, out, 0.05, 100, "general")}
        for name, launch in others.items():
            other = torch.full_like(cost, float("nan"))
            try:
                launch(cost, w1, w2, other)
            except RuntimeError as e:
                print(f"[{card}] {e}")
                continue
            torch.cuda.synchronize()
            print(f"[{card}] {name} general route ({bsz},{n1},{n2}): max|d|="
                  f"{(other - want).abs().max().nan_to_num(float('inf')).item():.3e}")
            fns[name] = lambda launch=launch, other=other: launch(cost, w1, w2, other)
        ms = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            ms[name].append(time_ms(fns[name], reps))
        plain = time_ms(lambda: sinkhorn_reference(cost, w1, w2), 3, warm=1)
        this = sum(ms["this"]) / 2
        print(f"[{card}] sinkhorn general ({bsz},{n1},{n2}) iters 100 ms per bare launch: {ms}, "
              f"plain {plain:.4f}"
              + "".join(f", {name}/this {sum(t) / 2 / this:.2f}"
                        for name, t in ms.items() if name != "this"))
        del cost, w1, w2, out, got, want
    return ok


def window_bound_ms(b: int, res: int, c: int, heads: int, window: int = 7) -> float:
    """Least ms of one launch: its qkv read and its output written once (bf16)
    at 3.35 TB/s, or 4 n^2 hd flops a (window, head) at 989 TFLOP/s."""
    n = window * window
    bytes_ = b * res * res * 4 * c * 2 + (2 * window - 1) ** 2 * heads * 4
    flops = b * (res // window) ** 2 * heads * 4 * n * n * (c // heads)
    return max(bytes_ / 3.35e12, flops / 989e12) * 1e3


def _window(card, gen, dev, reps) -> bool:
    """The window kernel against its plain version at every Swin-T stage,
    shifted and not (the bare launch into a NaN-filled output, and the op),
    then, at a 2,560-image batch, the bare launch timed beside its bound and
    the plain version, and a block's span (qkv, attention, proj) on the
    kernel and on the einsum path, in turns."""
    from ..models.common import init_weights
    from ..models.swin import SwinBlock

    ok = True
    for res, c, heads, shift in WINDOW_STAGES:
        blk = SwinBlock(c, res, heads, 7, shift, dtype=BF16)
        init_weights(blk, torch.Generator().manual_seed(res))
        blk = blk.to(dev).eval()
        with torch.no_grad():
            blk.attn.relative_position_bias_table.normal_(generator=gen)
        table = blk.attn.relative_position_bias_table.detach()
        scale = (c // heads) ** -0.5
        for s in sorted({0, shift}):
            qkv = torch.randn(WINDOW_CHECK_BATCH, res, res, 3 * c, generator=gen,
                              device=dev).to(BF16)
            want = wa.window_attention_reference(qkv, table, heads, 7, s, scale).float()
            out = torch.full((WINDOW_CHECK_BATCH, res, res, c), float("nan"), dtype=BF16,
                             device=dev)
            wa._launch(qkv, table, out, heads, 7, s, scale)
            got = wa.window_attention(qkv, table, heads, 7, s, scale)
            torch.cuda.synchronize()
            err = max((o.float() - want).abs().max().nan_to_num(float("inf")).item()
                      for o in (out, got))
            good = err <= TOL[BF16]
            ok &= good
            print(f"[{card}] window_attention ({WINDOW_CHECK_BATCH},{res},{res},{3 * c}) heads "
                  f"{heads} shift {s}: max|d|={err:.3e}{'' if good else '  FAIL'}")
            del qkv, want, out, got
        b = WINDOW_BATCH
        qkv = torch.randn(b, res, res, 3 * c, generator=gen, device=dev).to(BF16)
        out = torch.empty(b, res, res, c, dtype=BF16, device=dev)
        y = torch.randn(b, res, res, c, generator=gen, device=dev).to(BF16)
        with torch.inference_mode():
            fns = {"kernel": lambda: wa._launch(qkv, table, out, heads, 7, shift, scale),
                   "span_kernel": lambda: blk.attn.fused(y, 7, shift),
                   "span_einsum": lambda: blk.einsum_attention(y)}
            ms = {name: [] for name in fns}
            for name in list(fns) + list(fns)[::-1]:
                ms[name].append(time_ms(fns[name], reps))
            plain = time_ms(lambda: wa.window_attention_reference(qkv, table, heads, 7, shift,
                                                                  scale), 2, warm=1)
        bound = window_bound_ms(b, res, c, heads)
        kernel = sum(ms["kernel"]) / 2
        print(f"[{card}] window_attention ({b},{res},{res},{3 * c}) heads {heads} shift {shift} "
              f"ms: {ms}, bound {bound:.4f} ({100 * bound / kernel:.1f}% of it), "
              f"plain {plain:.3f}")
        del qkv, out, y, blk
    return ok


def block_bound_ms(blocks: int, n: int, c: int, heads: int) -> float:
    """Least ms of one launch over ``blocks`` blocks of ``n`` tokens: q, k,
    v read and the output written once (bf16) at 3.35 TB/s, or 4 n^2 hd
    flops a (block, head) at 989 TFLOP/s."""
    bytes_ = blocks * n * 4 * c * 2
    flops = blocks * heads * 4 * n * n * (c // heads)
    return max(bytes_ / 3.35e12, flops / 989e12) * 1e3


def block_off(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest of |got - want| - (1e-2 + 2^-6 |want|) over the
    elements: at most 0 where every element is within the rule (a NaN is
    infinitely far)."""
    d = (got.float() - want.float()).abs().nan_to_num(float("inf"))
    return (d - (BLOCK_ATOL + BLOCK_RTOL * want.float().abs())).max().item()


def block_rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """rms(got - want) / rms(want) over the elements, in fp32 (a NaN is
    infinitely far): the error of the whole output, which a fault that moves
    every element a little (a padded key left in the softmax) cannot hide
    under the elementwise rule."""
    d = (got.float() - want.float()).nan_to_num(float("inf"))
    return (d.pow(2).mean() / want.float().pow(2).mean()).sqrt().item()


def _block(card, gen, dev, reps) -> bool:
    """The block kernel against its plain version at ``BLOCK_SHAPES`` (the
    bare launch into a NaN-filled output, and the op; q and k at std 1 and
    2), then, at a 2,560-image batch, the bare launch timed in turns with
    SDPA and a layer's span on the kernel and on the einsum path, beside its
    bound and the plain version."""
    from ..models.common import init_weights
    from ..models.nest import NestAttention

    ok = True
    for per_image, n, c, heads in BLOCK_SHAPES:
        scale = (c // heads) ** -0.5
        for std in (1.0, 2.0):
            qkv = torch.randn(BLOCK_CHECK_IMAGES, per_image, n, 3 * c, generator=gen,
                              device=dev)
            qkv[..., :2 * c] *= std
            qkv = qkv.to(BF16)
            want = ba.block_attention_reference(qkv, heads, scale)
            out = torch.full_like(want, float("nan"))
            ba._launch(qkv, out, heads, scale)
            got = ba.block_attention(qkv, heads, scale)
            torch.cuda.synchronize()
            off = max(block_off(o, want) for o in (out, got))
            rel = max(block_rel_rms(o, want) for o in (out, got))
            err = max((o.float() - want.float()).abs().max().item() for o in (out, got))
            good = off <= 0 and rel <= BLOCK_REL_RMS
            ok &= good
            print(f"[{card}] block_attention ({BLOCK_CHECK_IMAGES},{per_image},{n},{3 * c}) heads "
                  f"{heads} q,k std {std}: max|d|={err:.3e}, worst past 1e-2 + 2^-6|want| "
                  f"{off:.3e}, rms(d)/rms(want)={rel:.3e} (limit {BLOCK_REL_RMS})"
                  f"{'' if good else '  FAIL'}")
            del qkv, want, out, got
        b = BLOCK_IMAGES
        attn = NestAttention(c, heads, dtype=BF16)
        init_weights(attn, torch.Generator().manual_seed(n + c))
        attn = attn.to(dev).eval()
        qkv = torch.randn(b, per_image, n, 3 * c, generator=gen, device=dev).to(BF16)
        out = torch.empty(b, per_image, n, c, dtype=BF16, device=dev)
        y = torch.randn(b, per_image, n, c, generator=gen, device=dev).to(BF16)
        views = qkv.reshape(b * per_image, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        with torch.inference_mode():
            fns = {"kernel": lambda: ba._launch(qkv, out, heads, scale),
                   "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                       *views, scale=scale),
                   "span_kernel": lambda: attn.fused(y),
                   "span_einsum": lambda: attn(y)}
            ms = {name: [] for name in fns}
            for name in list(fns) + list(fns)[::-1]:
                ms[name].append(time_ms(fns[name], reps))
            chunks = [qkv[i:i + BLOCK_PLAIN_IMAGES] for i in range(0, b, BLOCK_PLAIN_IMAGES)]
            plain = time_ms(lambda: [ba.block_attention_reference(x, heads, scale)
                                     for x in chunks], 1, warm=1)
        bound = block_bound_ms(b * per_image, n, c, heads)
        kernel = sum(ms["kernel"]) / 2
        spans = {k: sum(ms[k]) / 2 for k in ("span_kernel", "span_einsum")}
        print(f"[{card}] block_attention ({b},{per_image},{n},{3 * c}) heads {heads} ms: {ms}, "
              f"bound {bound:.4f} ({100 * bound / kernel:.1f}% of it), plain {plain:.3f}; span "
              f"kernel/einsum {spans['span_kernel'] / spans['span_einsum']:.3f}")
        del qkv, out, y, views, attn, chunks
        torch.cuda.empty_cache()
    return ok


def layer_norm_bound_ms(rows: int, c: int) -> float:
    """Least ms of one launch: the bf16 rows read and written once and the
    fp32 weight and bias read once, at 3.35 TB/s."""
    return (rows * c * 2 * 2 + 2 * c * 4) / 3.35e12 * 1e3


def layer_norm_off(got: torch.Tensor, want: torch.Tensor) -> int:
    """The most bf16 ulps between ``got`` and ``want`` (bf16) over the
    elements more than 1e-4 apart: their bit patterns as sign and magnitude
    on one monotone integer line. An output near 0 cancels w x-hat against b
    and shows the fp32 sums' order unscaled; a NaN lies thousands of ulps
    from any number."""
    def line(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    far = (got.float() - want.float()).abs().nan_to_num(float("inf")) > 1e-4
    ulps = (line(got) - line(want)).abs()[far]
    return int(ulps.max().item()) if ulps.numel() else 0


def _layer_norm(card, gen, dev, reps) -> bool:
    """The LayerNorm kernel against its plain version at
    ``LAYER_NORM_CHECK_WIDTHS`` and row counts of 1, 7 and a ragged tail (the
    bare launch into a NaN-filled output, and the op), with random fp32
    weight and bias, within one bf16 ulp (``layer_norm_off``); then, at a
    2,560-image batch's shapes, the bare launch timed in turns with
    ``F.layer_norm`` on bf16 with bf16 weights, beside its bound and the
    plain version."""
    ok = True
    for c in LAYER_NORM_CHECK_WIDTHS:
        w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        for rows in LAYER_NORM_CHECK_ROWS:
            x = (3 * torch.randn(rows, c, generator=gen, device=dev) + 0.5).to(BF16)
            want = ln.layer_norm_reference(x, w, b, 1e-5, BF16)
            out = torch.full_like(x, float("nan"))
            ln._launch(x, w, b, out, 1e-5)
            got = ln.layer_norm(x, w, b, 1e-5)
            torch.cuda.synchronize()
            off = max(layer_norm_off(o, want) for o in (out, got))
            good = off <= 1
            ok &= good
            print(f"[{card}] layer_norm ({rows},{c}): at most {off} bf16 ulp off the plain "
                  f"version{'' if good else '  FAIL'}")
    for rows, c in LAYER_NORM_SHAPES:
        x = torch.randn(rows, c, generator=gen, device=dev).to(BF16)
        w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        w16, b16 = w.to(BF16), b.to(BF16)
        out = torch.empty_like(x)
        with torch.inference_mode():
            fns = {"kernel": lambda: ln._launch(x, w, b, out, 1e-5),
                   "library": lambda: torch.nn.functional.layer_norm(x, (c,), w16, b16, 1e-5)}
            ms = {name: [] for name in fns}
            for name in list(fns) + list(fns)[::-1]:
                ms[name].append(time_ms(fns[name], reps))
            plain = time_ms(lambda: ln.layer_norm_reference(x, w, b, 1e-5, BF16), 3, warm=1)
        bound = layer_norm_bound_ms(rows, c)
        kernel = sum(ms["kernel"]) / 2
        print(f"[{card}] layer_norm ({rows},{c}) ms: {ms}, bound {bound:.4f} "
              f"({100 * bound / kernel:.1f}% of it), plain {plain:.4f}")
        del x, out
    return ok


def mhsa_routes(q: torch.Tensor):
    """Every route that takes q: the general route, and the tensor-core
    route where it applies."""
    return ("general",) + (("tensor_core",) if attention.mhsa_route(q) == "tensor_core"
                           else ())


def _check_mhsa(card, gen, dev, b, h, t, hd, dtype):
    """Each route of fused_mhsa against the plain version on heads split out
    of a packed qkv; returns the views and the scale for timing."""
    qkv = torch.randn(b, t, 3, h, hd, generator=gen, device=dev).to(dtype)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    scale = hd ** -0.5
    want = fused_mhsa_reference(q, k, v, scale).float()
    errs = {}
    for route in mhsa_routes(q):
        out = torch.full((b, t, h, hd), float("nan"), dtype=dtype, device=dev)
        attention._launch(q, k, v, out.transpose(1, 2), scale, route)
        got = fused_mhsa(q, k, v, scale, route=route)
        torch.cuda.synchronize()
        errs[route] = max((o.float() - want).abs().max().nan_to_num(float("inf")).item()
                          for o in (out.transpose(1, 2), got))
        del out, got
    bad = {r: e for r, e in errs.items() if not e <= TOL[dtype]}
    print(f"[{card}] fused_mhsa ({b},{h},{t},{hd}) {dtype}: max|d| "
          + ", ".join(f"{r} {e:.3e}" for r, e in errs.items())
          + (f"  FAIL {bad}" if bad else ""))
    return q, k, v, scale, not bad


def main() -> int:
    watchdog_reexec(timeout_s=900.0)  # a hung launch fails loudly instead of hanging the run
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--ptxas", action="store_true", help="print every kernel's ptxas line")
    p.add_argument("--only", choices=("sinkhorn", "window", "layer_norm", "block"),
                   help="one kernel alone")
    p.add_argument("--against", nargs="+", default=(),
                   help="other sinkhorn.cu files whose general route is timed beside this one's")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernels.bench needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    logs = build.build({"sinkhorn": ("sinkhorn",), "window": ("window_attn",),
                        "layer_norm": ("layer_norm",), "block": ("block_attn",)}.get(
                            args.only, build.SOURCES))
    for name, log in logs.items():
        lines = build.ptxas_summary(log)
        spills = [x for x in lines if "spill" in x]
        print(f"ptxas {name}: {len(lines)} lines, {len(spills)} with spills")
        for line in (lines if args.ptxas else spills):
            print("  " + line)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)

    alone = {"window": _window, "layer_norm": _layer_norm, "block": _block}
    if args.only in alone:
        return 0 if alone[args.only](card, gen, dev, args.reps) else 1
    sinkhorn_only = args.only == "sinkhorn"
    ok = True if sinkhorn_only else (_window(card, gen, dev, args.reps)
                                     & _layer_norm(card, gen, dev, args.reps)
                                     & _block(card, gen, dev, args.reps))
    ok &= _sinkhorn_general(card, gen, dev, args.reps,
                           {src: _against(src, str(i)) for i, src in enumerate(args.against)})
    for b, h, t, hd in () if sinkhorn_only else MHSA_EDGES:
        for dtype in (F32, BF16):
            ok &= _check_mhsa(card, gen, dev, b, h, t, hd, dtype)[-1]
    for b, h, t, hd, dtypes in () if sinkhorn_only else MHSA_TIMED:
        for dtype in dtypes:
            q, k, v, scale, good = _check_mhsa(card, gen, dev, b, h, t, hd, dtype)
            ok &= good
            routes = mhsa_routes(q) + ("sdpa",)
            ms = {r: [] for r in routes}
            for route in routes + routes[::-1]:
                if route == "sdpa":
                    fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                        q, k, v, scale=scale)
                else:
                    fn = lambda: fused_mhsa(q, k, v, scale, route=route)  # noqa: E731
                ms[route].append(time_ms(fn, args.reps))
            plain = time_ms(lambda: fused_mhsa_reference(q, k, v, scale), 5, warm=1)
            print(f"[{card}] fused_mhsa ({b},{h},{t},{hd}) {dtype} ms per call: {ms}, "
                  f"plain {plain:.4f}")
            if (b, h, t, hd, dtype) == MHSA_GATE:
                tc, sdpa, general = (sum(ms[r]) / 2 for r in ("tensor_core", "sdpa", "general"))
                good = tc < sdpa and tc < general
                ok &= good
                print(f"[{card}] speed gate fused_mhsa ({b},{h},{t},{hd}) {dtype}: tensor_core "
                      f"{tc:.4f} ms against sdpa {sdpa:.4f}, general {general:.4f}: "
                      f"{'ok' if good else 'FAIL, not the fastest'}")
            del q, k, v

    from ..ops.emd import normalize_weights

    for bsz, n in ((3000, 13), (3000, 25), (160, 13)):
        cost = 2.0 * torch.rand(bsz, n, n, generator=gen, device=dev)
        w1 = normalize_weights(torch.rand(bsz, n, generator=gen, device=dev))
        w2 = normalize_weights(torch.rand(bsz, n, generator=gen, device=dev))
        want = sinkhorn_reference(cost, w1, w2)
        ms = {"general": [], "packed": []}
        for route in ms:
            out = torch.full_like(cost, float("nan"))
            sinkhorn._launch(cost, w1, w2, out, 0.05, 100, route)
            got = sinkhorn_pallas(cost, w1, w2, route=route)
            torch.cuda.synchronize()
            err = max((o - want).abs().max().nan_to_num(float("inf")).item() for o in (out, got))
            print(f"[{card}] sinkhorn_pallas ({bsz},{n},{n}) {route}: max|d|={err:.3e}")
            ok &= err <= 1e-4
        for route in ("general", "packed", "packed", "general"):
            ms[route].append(
                time_ms(lambda: sinkhorn_pallas(cost, w1, w2, route=route), args.reps))
        print(f"[{card}] sinkhorn_pallas ({bsz},{n},{n}) iters 100 ms per call: {ms}")
        if bsz == SINKHORN_GATE_BATCH:
            packed, general = sum(ms["packed"]) / 2, sum(ms["general"]) / 2
            good = packed < general
            ok &= good
            print(f"[{card}] speed gate sinkhorn_pallas ({bsz},{n},{n}): packed {packed:.4f} ms "
                  f"against general {general:.4f}: {'ok' if good else 'FAIL, not faster'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
