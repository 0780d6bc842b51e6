"""Traffic ``nest_episodic_eval``: Meta-Baseline episodes over a NesT
encoder, scored by ``fewshot_vit_tpu_torch.eval.episodic.evaluate`` as in
``episodic_eval``, held to the plain NesT reference (``reference/nest.py``).

Like ``swin_episodic_eval``, this driver carries its own ``__init__``,
``count_flops`` and ``check`` (``drivers/common.py`` names Visformer's
reference, ``swin_episodic_eval`` Swin's), with the NesT reference in their
place; NesT has no BN to calibrate. The seed's draw gives every 2-D tensor
a std of 0.02 and the positional embeddings 0.02 clipped at two std; the
configuration rescales the linear kernels to ``linear_gain / sqrt(fan_in)``
and the positional embeddings to ``pos_embed_std``. The traffic has no fold
and no fused route (NesT has neither); its control is
``{"reference_quant": "fp8"}``, the reference with fp8 products in the
program's place. The faults: ``no_pos_embed`` (every level's positional
embedding zeroed in the program) and ``merge_head_major`` (the proj
kernels' input columns permuted so that the program computes what a port
merging its heads head-major, channel = h * d_head + d, would)."""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from .. import inputs
from ..core import Check
from ..reference.nest import Encoder, param_shapes
from ..roofline import model_peak
from . import episodic_eval

POS_EMBED = "pos_embed"
DRAWN_STD = 0.02  # inputs.weights' std of a 2-D tensor and of a positional embedding
FAULTS = ("no_pos_embed", "merge_head_major")


def encoder_args(cfg: dict) -> dict:
    args = dict(cfg["encoder_args"])
    for k in ("embed_dims", "num_heads", "depths"):
        args[k] = tuple(args[k])
    return args


def head_major(weight: torch.Tensor, heads: int) -> torch.Tensor:
    """A proj kernel (C, C) whose input columns are taken in head-major order:
    column d * H + h of the result is column h * d_head + d of ``weight``."""
    c = weight.shape[1]
    order = torch.arange(c, device=weight.device).reshape(heads, c // heads).t().reshape(-1)
    return weight[:, order]


class Cell(episodic_eval.Cell):
    op_names = ()

    def __init__(self, spec: dict, device, seed: int, control: bool = False,
                 fault: Optional[str] = None):
        cfg, tr = spec["config"], spec["traffic"]
        if tr["fold_bn"] or tr["use_pallas_attn"]:
            raise ValueError("NesT has no BN to fold and no fused block route")
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
        shapes = {f"encoder.{k}": v for k, v in param_shapes(self.enc_args).items()}
        shapes.update(self.head_shapes())
        self.params = inputs.weights(shapes, seed, device)
        for k, v in self.params.items():
            if k.endswith(POS_EMBED):
                v.mul_(float(cfg["pos_embed_std"]) / DRAWN_STD)
            elif v.dim() == 2:  # a linear kernel (out, in)
                v.mul_(float(cfg["linear_gain"]) / math.sqrt(v.shape[1]) / DRAWN_STD)
        self.dtype = tr["dtype"]
        self.peak_flops = model_peak(self.dtype)
        self.units_per_call = self.attempts_per_call = self.n_episodes
        self.extra = {"encoder_args": self.enc_args, "dtype": self.dtype}
        self._sink, self.records, self._tf32 = None, [], None
        # the program before the split: one without this encoder stops here
        self.head = self.build()
        self.capture()
        sp = cfg["split"]
        self.images = inputs.split(sp["classes"], sp["per_class"], sp["image_size"], seed, device)
        rng = inputs.host_rng(seed, 3)
        self.index_sets = [self.layout(inputs.episodes(
            rng, self.n_batches * self.epb, sp["classes"], sp["per_class"], self.way, self.n_per))
            for _ in range(tr["index_sets"])]
        self.flops_per_unit = self.count_flops() / self.epb

    def build(self):
        from fewshot_vit_tpu_torch.core.registry import models
        from fewshot_vit_tpu_torch.heads import meta_baseline  # noqa: F401  (registers)

        head = models.make("meta-baseline", encoder=self.cfg["encoder"],
                           encoder_args=dict(self.enc_args), method=self.cfg["method"],
                           temp=float(self.cfg["temp"]), dtype=getattr(torch, self.dtype),
                           device=self.dev, seed=0)
        head.load_state_dict(self.state_dict(), strict=True)
        with torch.no_grad():
            if self.fault == "no_pos_embed":
                for name, p in head.named_parameters():
                    if name.endswith(POS_EMBED):
                        p.zero_()
            elif self.fault == "merge_head_major":
                for level in head.encoder.levels:
                    for layer in level.transformer_encoder:
                        proj = layer.attn.proj.weight
                        proj.copy_(head_major(proj, layer.attn.num_heads))
        self.temp = float(self.params["temp"])
        self.dataset = SimpleNamespace(mean=np.asarray(self.mean, np.float32),
                                       std=np.asarray(self.std, np.float32))
        return head

    def reference(self, **kw) -> Encoder:
        return Encoder(self.encoder_params(), self.enc_args, **kw)

    def count_flops(self) -> float:
        """Model FLOPs of one batch, counted over the reference on the meta
        device at the cell's shapes."""
        from torch.utils.flop_counter import FlopCounterMode

        meta = {k: torch.empty(v.shape, device="meta") for k, v in self.encoder_params().items()}
        size = self.cfg["split"]["image_size"]
        images = torch.empty((self.epb * self.way * self.n_per, size, size, 3),
                             dtype=torch.uint8, device="meta")
        with FlopCounterMode(display=False) as fc:
            self.reference_logits(images, Encoder(meta, self.enc_args))
        return float(fc.get_total_flops())

    def check(self, everything: bool = False) -> List[Check]:
        """``common.EpisodeCell.check`` with the NesT reference: the same
        numbers, limits and held-to-zero counts."""
        pairs = [(i, b) for i, r in enumerate(self.records) for b in range(len(r["logits"]))]
        rng = inputs.host_rng(self.seed, 4)
        take = rng.choice(len(pairs), size=min(self.tr["check_batches"], len(pairs)),
                          replace=False)
        quant = self.tr["control"].get("reference_quant") if self.control else None
        with_bf16 = everything or "logit_vs_bf16" in self.limits
        labels = self.query_labels()
        enc = self.reference()
        gap, sq, sq16, count, outside = 0.0, 0.0, 0.0, 0, 0
        for t in sorted(take):
            i, b = pairs[t]
            rec = self.records[i]
            images = self.batch_images(self.index_sets[rec["set"]][b])
            with inputs.exact_fp32(), torch.no_grad():
                ref = self.reference_logits(images, enc).double()
                if quant:  # the control: the reference, rounded, takes the program's place
                    got = self.reference_logits(images, self.reference(quant=quant)).double()
                    accs = (got.argmax(-1) == labels).double().mean(-1).cpu().numpy()
                else:
                    got = rec["logits"][b].double()
                    accs = rec["accs"][b * self.epb:(b + 1) * self.epb]
                if with_bf16:
                    r16 = self.reference_logits(images,
                                                self.reference(compute=torch.bfloat16)).double()
                    sq16 += float(((r16 - ref) ** 2).sum())
            diff = (got - ref).abs()
            g = float(diff.max())
            gap, sq, count = max(gap, g), sq + float((diff * diff).sum()), count + diff.numel()
            top2 = ref.topk(2, dim=-1)
            decided = (top2.values[..., 0] - top2.values[..., 1]) > 2 * g
            right = (decided & (top2.indices[..., 0] == labels)).sum(-1).cpu().numpy()
            open_ = (~decided).sum(-1).cpu().numpy()
            n = np.rint(np.asarray(accs, np.float64) * labels.shape[-1])
            outside += int(np.sum((n < right) | (n > right + open_)))
        mse = sq / max(count, 1)
        numbers = {"logit_gap": gap, "logit_rms": mse ** 0.5, "logit_mse": mse}
        if with_bf16:
            numbers["logit_vs_bf16"] = (sq / max(sq16, 1e-300)) ** 0.5
        checks = [Check(k, v, float(self.limits.get(k, float("inf")))) for k, v in numbers.items()
                  if k in self.limits or everything]
        return checks + [Check("acc_outside", float(outside), 0.0),
                         Check("route_off", float(self.route_off()), 0.0)]
