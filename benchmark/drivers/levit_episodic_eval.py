"""Traffic ``levit_episodic_eval``: Meta-Baseline episodes over a LeViT
encoder, scored by ``fewshot_vit_tpu_torch.eval.episodic.evaluate`` as in
``episodic_eval``, held to the plain LeViT reference (``reference/levit.py``).

The comparison is ``nest_episodic_eval``'s, which reaches its reference
through ``reference()``; this driver gives the LeViT reference there and
carries its own ``__init__``, ``build`` and ``count_flops``. The seed's draw
gives every 2-D tensor a std of 0.02; the configuration rescales the linear
kernels to ``linear_gain / sqrt(fan_in)``, the attention-bias tables to
``bias_table_std`` and the scales of the BN closing each residual branch
(the attention's proj, the MLP's second LinearNorm) to ``branch_bn_scale``
times 1 + 0.1 std: LeViT starts those at 0, which would switch every
branch off, and at 1 the random network amplifies bf16 rounding layer by
layer. The other BN scales come as 1 + 0.1 std; the running statistics are
set from ``calibration_images`` of the split through the reference. With
``fold_bn`` the program is folded at set-up (``models/fold.py::fold_levit``)
while the reference stays unfolded, so the check holds the fold too. LeViT
has no fused attention route. The control is ``{"reference_quant":
"fp8"}``, the reference with fp8 products in the program's place. The
faults, each made in the program after the fold: ``no_attn_bias`` (every
bias table zeroed), ``bias_stride_1`` (each subsampling attention's offset
table built at stride 1) and ``no_hardswish`` (the hard-swish before each
attention's proj left out)."""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .. import inputs
from ..reference.heads import normalize
from ..reference.levit import Encoder, param_shapes
from ..roofline import model_peak
from . import nest_episodic_eval

BIAS_TABLE = "attention_biases"
BRANCH_BN = (".m.proj.1.bn.weight", ".m.2.bn.weight")  # the last BN of a residual branch
DRAWN_STD = 0.02  # inputs.weights' std of a 2-D tensor
FAULTS = ("no_attn_bias", "bias_stride_1", "no_hardswish")


def encoder_args(cfg: dict) -> dict:
    args = dict(cfg["encoder_args"])
    for k in ("embed_dim", "depth", "num_heads"):
        args[k] = tuple(args[k])
    return args


def break_program(encoder: torch.nn.Module, fault: str) -> None:
    """Make ``fault`` (``FAULTS``) in a built LeViT encoder, in place."""
    from fewshot_vit_tpu_torch.models.levit import (
        LevitAttention, LevitAttentionSubsample, attention_bias_idxs)

    for m in encoder.modules():
        if not isinstance(m, (LevitAttention, LevitAttentionSubsample)):
            continue
        if fault == "no_attn_bias":
            with torch.no_grad():
                m.attention_biases.zero_()
        elif fault == "no_hardswish":
            m.proj[0] = torch.nn.Identity()
        elif fault == "bias_stride_1" and isinstance(m, LevitAttentionSubsample):
            nq, nkv = m.attention_bias_idxs.shape
            idxs, _ = attention_bias_idxs(math.isqrt(nq), math.isqrt(nkv), 1)
            m.attention_bias_idxs = torch.from_numpy(idxs).to(m.attention_bias_idxs.device)


class Cell(nest_episodic_eval.Cell):
    def __init__(self, spec: dict, device, seed: int, control: bool = False,
                 fault: Optional[str] = None):
        cfg, tr = spec["config"], spec["traffic"]
        if tr["use_pallas_attn"]:
            raise ValueError("LeViT has no fused attention route")
        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.tr, self.limits = cfg, tr, spec["limits"]
        self.dev, self.seed, self.control, self.fault = device, int(seed), control, fault
        self.enc_args = encoder_args(cfg)
        self.mean, self.std = cfg["normalize"]["mean"], cfg["normalize"]["std"]
        self.way, self.shot, self.query = tr["way"], tr["shot"], tr["query"]
        self.n_per = self.shot + self.query
        self.epb, self.n_episodes = tr["ep_per_batch"], tr["episodes_per_call"]
        self.n_batches = math.ceil(self.n_episodes / self.epb)
        sp = cfg["split"]
        self.images = inputs.split(sp["classes"], sp["per_class"], sp["image_size"], seed, device)
        rng = inputs.host_rng(seed, 3)
        self.index_sets = [self.layout(inputs.episodes(
            rng, self.n_batches * self.epb, sp["classes"], sp["per_class"], self.way, self.n_per))
            for _ in range(tr["index_sets"])]
        shapes = {f"encoder.{k}": v for k, v in param_shapes(self.enc_args).items()}
        shapes.update(self.head_shapes())
        self.params = inputs.weights(shapes, seed, device)
        for k, v in self.params.items():
            if k.endswith(BIAS_TABLE):
                v.mul_(float(cfg["bias_table_std"]) / DRAWN_STD)
            elif k.endswith(BRANCH_BN):
                v.mul_(float(cfg["branch_bn_scale"]))
            elif v.dim() == 2:  # a linear kernel (out, in)
                v.mul_(float(cfg["linear_gain"]) / math.sqrt(v.shape[1]) / DRAWN_STD)
        calib = rng.choice(len(self.images), size=cfg["calibration_images"], replace=False)
        self.calibrate(self.images[torch.from_numpy(np.sort(calib)).to(device)])
        self.dtype = tr["dtype"]
        self.peak_flops = model_peak(self.dtype)
        self.units_per_call = self.attempts_per_call = self.n_episodes
        self.extra = {"encoder_args": self.enc_args, "dtype": self.dtype,
                      "images_per_batch": self.epb * self.way * self.n_per}
        self._sink, self.records, self._tf32 = None, [], None
        self.head = self.build()
        self.capture()
        self.flops_per_unit = self.count_flops() / self.epb

    @torch.no_grad()
    def calibrate(self, images_u8: torch.Tensor) -> None:
        """Every BN's running statistics, in place, from the batch statistics
        of ``images_u8`` flowing through the reference, layer by layer."""
        with inputs.exact_fp32():
            enc = self.reference(bn="batch")
            enc(normalize(images_u8, self.mean, self.std))
        for k, v in enc.stats.items():
            self.params[f"encoder.{k}"].copy_(v)

    def build(self):
        from fewshot_vit_tpu_torch.core.registry import models
        from fewshot_vit_tpu_torch.heads import meta_baseline  # noqa: F401  (registers)
        from fewshot_vit_tpu_torch.models.fold import fold_encoder_in_head

        head = models.make("meta-baseline", encoder=self.cfg["encoder"],
                           encoder_args=dict(self.enc_args), method=self.cfg["method"],
                           temp=float(self.cfg["temp"]), dtype=getattr(torch, self.dtype),
                           device=self.dev, seed=0)
        head.load_state_dict(self.state_dict(), strict=True)
        if self.tr["fold_bn"]:
            head = fold_encoder_in_head(head)
        if self.fault:
            break_program(head.encoder, self.fault)
        self.temp = float(self.params["temp"])
        self.dataset = SimpleNamespace(mean=np.asarray(self.mean, np.float32),
                                       std=np.asarray(self.std, np.float32))
        return head

    def reference(self, params=None, **kw) -> Encoder:
        return Encoder(self.encoder_params() if params is None else params, self.enc_args, **kw)

    def count_flops(self) -> float:
        """Model FLOPs of one batch, counted over the reference on the meta
        device at the cell's shapes."""
        from torch.utils.flop_counter import FlopCounterMode

        meta = {k: torch.empty(v.shape, device="meta") for k, v in self.encoder_params().items()}
        size = self.cfg["split"]["image_size"]
        images = torch.empty((self.epb * self.way * self.n_per, size, size, 3),
                             dtype=torch.uint8, device="meta")
        with FlopCounterMode(display=False) as fc:
            self.reference_logits(images, self.reference(meta))
        return float(fc.get_total_flops())
