"""int8-quantized eval forward (counterpart: ``fewshot_vit_tpu/models/quant.py``).

  * **weights**: per-output-channel symmetric int8, quantized once on the
    host in float64 from the FOLDED eval weights (``models/fold.py``: the
    BNs must be folded first so their affines are inside the grid);
  * **activations**: per-tensor symmetric int8, the scale max|x| / 127
    computed in the graph (dynamic) or calibrated once and stored as an
    ``ascale`` buffer (static). Symmetric quantization maps 0 to 0, so the
    convs' zero padding stays exact;
  * **products**: int8 x int8 -> int32 through ``torch._int_mm`` (cuBLASLt's
    integer GEMM on the card), dequantized as ``y.float() * (s * ws)`` plus
    the bias, then cast to the compute dtype, in JAX's order. A conv is an
    im2col of the int8 input (``Tensor.unfold`` views, copied per chunk of
    images) followed by one GEMM per group. Softmax, pooling, residuals and
    the final norm stay in the compute dtype.

``torch._int_mm`` on the card takes M > 16 and K, N multiples of 8: the
products pad K and N with zeros (exact) and M with zero rows that are
dropped. The JAX package computes the same products with ``lax`` ops, not a
Pallas kernel, so a library GEMM is their counterpart here.

Weights keep the float model's layouts (conv OIHW, 1x1 ``(O, I, 1, 1)``), so
a quantized state dict has the folded one's keys plus ``wscale`` (and
``ascale``) beside each ``weight``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv

# int8 im2col rows plus their int32 and fp32 results per chunk of images
_CHUNK_BYTES = 256 << 20
_MIN_ROWS = 17  # torch._int_mm on the card takes M > 16


def dynamic_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor -> (int8 tensor, fp32 0-d scale), scale = max(max|x| / 127,
    1e-12), round half to even, clipped to +-127."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax() / 127.0, min=1e-12)
    return _quant(xf, s), s


def _quant(xf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)


def quantize_kernel(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 kernel in the port's layout, output channels first (OIHW,
    ``(O, I, 1, 1)``) -> (int8 kernel, fp32 per-output-channel scale), in
    float64 on the host."""
    k = k.detach().cpu().double()
    ws = torch.clamp(k.abs().flatten(1).amax(dim=1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(k / ws.reshape(-1, *[1] * (k.dim() - 1))), -127, 127)
    return q.to(torch.int8), ws.float()


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8, w (N, K) int8 -> (M, N) int32 = a @ w.T through
    ``torch._int_mm``, with K and N zero-padded to multiples of 8 and M to at
    least 17 rows (both exact: the padding adds zeros, its rows are dropped)."""
    m, k = a.shape
    n = w.shape[0]
    pk, pn, pm = -k % 8, -n % 8, max(0, _MIN_ROWS - m)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w = F.pad(w, (0, pk, 0, pn))
    y = torch._int_mm(a, w.t())  # a row-major, w column-major: cuBLASLt's int8 layout
    return y[:m, :n] if (pm or pn) else y


def _dequant(y: torch.Tensor, s: torch.Tensor, ws: torch.Tensor, bias, dtype) -> torch.Tensor:
    y = y.float() * (s * ws)
    if bias is not None:
        y = y + bias
    return y.to(dtype)


class _QuantLayer(nn.Module):
    """int8 weight (``weight``), fp32 ``wscale`` per output channel, an
    optional fp32 ``bias`` and, for static activations, an fp32 0-d
    ``ascale``; all buffers, filled by ``load_state_dict``."""

    def __init__(self, shape, bias: bool, static_act: bool, dtype: torch.dtype):
        super().__init__()
        self.register_buffer("weight", torch.zeros(shape, dtype=torch.int8))
        self.register_buffer("wscale", torch.ones(shape[0]))
        self.register_buffer("bias", torch.zeros(shape[0]) if bias else None)
        self.register_buffer("ascale", torch.ones(()) if static_act else None)
        self.static_act = static_act
        self.dtype = dtype

    def act_quant(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dynamic (the scale from this tensor) or static (``ascale``)."""
        if self.static_act:
            return _quant(x.float(), self.ascale), self.ascale
        return dynamic_quant(x)


class QuantDense(_QuantLayer):
    """int8 dense layer over the channel (last) axis, in place of a 1x1
    ``Conv``: weight ``(O, I, 1, 1)``, one int32 GEMM over the flattened rows."""

    def __init__(self, cin: int, cout: int, bias: bool = False, static_act: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__((cout, cin, 1, 1), bias, static_act, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, s = self.act_quant(x)
        y = int8_matmul(q.reshape(-1, q.shape[-1]), self.weight.flatten(1))
        y = _dequant(y, s, self.wscale, self.bias, self.dtype)
        return y.reshape(*x.shape[:-1], y.shape[-1])


class QuantConv(_QuantLayer):
    """int8 conv over NHWC input, in place of a ``Conv``: weight OIHW
    ``(O, I/g, k, k)``; im2col of the int8 input, one int32 GEMM per group,
    over chunks of images that keep each chunk's rows under
    ``_CHUNK_BYTES``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 groups: int = 1, bias: bool = False, static_act: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__((cout, cin // groups, k, k), bias, static_act, dtype)
        self.k, self.stride, self.padding, self.groups = k, stride, padding, groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, s = self.act_quant(x)
        outs = [_dequant(y, s, self.wscale, self.bias, self.dtype)
                for y in conv_int32_chunks(q, self.weight, self.stride, self.padding, self.groups)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)


def layer_factory(quant_int8: Any, dtype: torch.dtype) -> Tuple[Callable[..., nn.Module],
                                                                 Callable[..., nn.Module]]:
    """``(dense, conv)`` builders of an encoder's quantizable layers:
    ``dense(cin, cout, bias=False)`` a 1x1 and ``conv(cin, cout, k, stride=1,
    padding=0, groups=1, bias=False)``. With ``quant_int8`` (``True``:
    dynamic activation scales, ``"static"``: calibrated) ``QuantDense`` and
    ``QuantConv``, else the float ``Conv``."""
    if not quant_int8:
        return ((lambda cin, cout, bias=False: Conv(cin, cout, bias=bias, dtype=dtype)),
                (lambda cin, cout, k, stride=1, padding=0, groups=1, bias=False:
                 Conv(cin, cout, k, stride, padding, groups, bias, dtype)))
    static = quant_int8 == "static"
    return ((lambda cin, cout, bias=False: QuantDense(cin, cout, bias, static, dtype)),
            (lambda cin, cout, k, stride=1, padding=0, groups=1, bias=False:
             QuantConv(cin, cout, k, stride, padding, groups, bias, static, dtype)))


def conv_int32_chunks(q: torch.Tensor, weight: torch.Tensor, stride: int = 1, padding: int = 0,
                      groups: int = 1):
    """int8 NHWC input, int8 OIHW weight -> the int32 conv output (NHWC), in
    chunks of images (yielded in order) whose im2col rows, int32 results
    and fp32 dequantization stay under ``_CHUNK_BYTES`` together."""
    k = weight.shape[-1]
    if padding:
        q = F.pad(q, (0, 0, padding, padding, padding, padding))
    b, hp, wp, c = q.shape
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    cout, cg = weight.shape[:2]
    og = cout // groups
    w = weight.flatten(1)  # (O, I/g * k * k), the im2col order (c, i, j)
    chunk = max(1, _CHUNK_BYTES // (ho * wo * (c * k * k + 8 * cout)))
    for b0 in range(0, b, chunk):
        cols = q[b0:b0 + chunk].unfold(1, k, stride).unfold(2, k, stride)  # (b, Ho, Wo, C, k, k)
        ys = [int8_matmul(cols[:, :, :, i * cg:(i + 1) * cg].reshape(-1, cg * k * k),
                          w[i * og:(i + 1) * og]) for i in range(groups)]
        y = ys[0] if groups == 1 else torch.cat(ys, dim=-1)
        yield y.reshape(cols.shape[0], ho, wo, cout)


QUANT_LAYERS = (QuantDense, QuantConv)


def quantize_visformer(folded: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """FOLDED Visformer state dict -> the state dict of the same
    architecture built with ``fold_bn=True, quant_int8=True``: every conv
    weight (every 4-D ``weight``) int8 with its ``wscale``; biases,
    positional embeddings and the final norm pass through. JAX's
    ``quantize_tree`` (every ``kernel`` of the params) and
    ``quantize_visformer`` (params and batch stats) in one, since a state
    dict holds both."""
    out: Dict[str, torch.Tensor] = {}
    for key, v in folded.items():
        if key.endswith(".weight") and v.dim() == 4:
            out[key], out[key[: -len("weight")] + "wscale"] = quantize_kernel(v)
        else:
            out[key] = v.detach().cpu()
    return out


@torch.no_grad()
def calibrate(encoder: nn.Module, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Module name -> the dynamic activation scale each int8 layer of
    ``encoder`` (built with ``quant_int8=True``) computes over ``images``
    (a normalized model-input batch), recorded by forward hooks during one
    forward: JAX's sown ``intermediates``."""
    scales: Dict[str, torch.Tensor] = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: scales.__setitem__(name, dynamic_quant(inp[0])[1]))
        for name, m in encoder.named_modules() if isinstance(m, QUANT_LAYERS)]
    try:
        encoder(images)
    finally:
        for h in hooks:
            h.remove()
    return scales


def _insert_ascales(state_dict: Dict[str, torch.Tensor], scales: Mapping[str, torch.Tensor]) -> None:
    """Write calibrated ``ascale`` entries (``calibrate``'s) into the
    quantized state dict, in place."""
    for name, s in scales.items():
        state_dict[f"{name}.ascale"] = s.detach().float().cpu().reshape(())


def quantize_encoder_in_head(head, calib_images: Union[None, torch.Tensor] = None):
    """Fold and quantize the ``encoder`` of a head: returns a new head whose
    encoder is built with ``quant_int8``. Raises NotImplementedError for an
    encoder family without a BN folder (folding comes first) or without an
    int8 path, as JAX does.

    With ``calib_images`` (a normalized model-input batch on the encoder's
    device) the activation scales are calibrated on that batch and stored as
    static ``ascale`` buffers (``quant_int8="static"``); without it they are
    dynamic."""
    from .fold import fold_encoder_in_head

    folded = fold_encoder_in_head(head)
    enc = folded.encoder
    if "quant_int8" not in getattr(enc, "config", {}):
        raise NotImplementedError(f"encoder {type(enc).__name__} has no int8 path")
    q_sd = quantize_visformer(enc.state_dict())
    mode: Union[bool, str] = True
    if calib_images is not None:
        dyn = enc.clone(quant_int8=True)
        dyn.load_state_dict(q_sd)
        _insert_ascales(q_sd, calibrate(dyn, calib_images))
        mode = "static"
    q_enc = enc.clone(quant_int8=mode)
    q_enc.load_state_dict(q_sd)
    new_head = folded.clone(encoder=q_enc)
    sd = {f"encoder.{k}": v for k, v in q_enc.state_dict().items()}
    sd.update({k: v for k, v in folded.state_dict().items() if not k.startswith("encoder.")})
    new_head.load_state_dict(sd)
    return new_head
