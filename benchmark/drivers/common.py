"""What the eval drivers share: the split, the episode index sets and the
weights made from the seed, the hooks that keep every batch's logits and a
CUDA event at its end, and the comparison of the window's answers with the
reference's."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import inputs
from ..core import Check
from ..reference.heads import normalize
from ..reference.visformer import Encoder, param_shapes
from ..roofline import model_peak
from ..tracing import event


def launch_counts() -> Dict[str, int]:
    """The program's kernel launches so far, by ``<kernel>.<route>``."""
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas

    return {**{f"fused_mhsa.{r}": n for r, n in fused_mhsa.route_launches.items()},
            **{f"sinkhorn_pallas.{r}": n for r, n in sinkhorn_pallas.route_launches.items()}}


def tf32_matmul_on() -> bool:
    """Let fp32 matmuls take TF32 (the fp32 cells' control); -> the setting
    it replaces."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    return was


def encoder_args(cfg: dict) -> dict:
    """The configuration's encoder widths, as both sides take them."""
    args = dict(cfg["encoder_args"])
    args["depth"] = tuple(args["depth"])
    return args


class EpisodeCell:
    """An eval cell: each call evaluates one of ``index_sets`` episode index
    sets drawn from the seed, in turn, and the head's output is kept per
    batch. Subclasses build the program (``build``), say how a call's and a
    batch's indices lie (``layout``, ``batch_images``) and compute the
    reference's logits (``reference_logits``)."""

    kind, unit = "eval", "episodes"
    op_names: tuple = ()

    def __init__(self, spec: dict, device, seed: int, control: bool = False,
                 fault: Optional[str] = None):
        cfg, tr = spec["config"], spec["traffic"]
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
        enc = self.encoder_params()
        calib = rng.choice(len(self.images), size=cfg["calibration_images"], replace=False)
        self.calib_images = self.images[torch.from_numpy(np.sort(calib)).to(device)]
        inputs.calibrate(enc, self.enc_args, normalize(self.calib_images, self.mean, self.std))
        self.dtype = tr["dtype"]
        self.peak_flops = model_peak(self.dtype)
        self.units_per_call = self.attempts_per_call = self.n_episodes
        self.extra = {"solver_iters": cfg.get("solver_iters")}

        self._sink: Optional[dict] = None
        self.records: List[dict] = []
        self._tf32 = tf32_matmul_on() if control and tr["control"].get("tf32_matmul") else None
        self.head = self.build()
        self.capture()
        self.flops_per_unit = self.count_flops() / self.epb

    # --- what a subclass gives ------------------------------------------------
    def head_shapes(self) -> Dict[str, tuple]:
        return {}

    def layout(self, eps: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def build(self):
        raise NotImplementedError

    def capture(self) -> None:
        """Keep every batch's logits: a hook on the head's forward."""
        self.head.register_forward_hook(self._after_batch)

    def evaluate(self, indices: np.ndarray):
        raise NotImplementedError

    def batch_images(self, indices: np.ndarray) -> torch.Tensor:
        raise NotImplementedError

    def reference_logits(self, images_u8: torch.Tensor, enc: Encoder) -> torch.Tensor:
        raise NotImplementedError

    def query_labels(self) -> torch.Tensor:
        raise NotImplementedError

    # --- the shared path ------------------------------------------------------
    def encoder_params(self) -> Dict[str, torch.Tensor]:
        return {k[len("encoder."):]: v for k, v in self.params.items() if k.startswith("encoder.")}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.clone() for k, v in self.params.items()}

    def _after_batch(self, module, args, out):
        if self._sink is not None:
            ev = event(self.dev)
            ev.record()
            self._sink["events"].append(ev)
            self._sink["logits"].append(out)

    def _run(self, k: int, batches: Optional[int] = None, keep: bool = True):
        indices = self.index_sets[k] if batches is None else self.index_sets[k][:batches]
        start = event(self.dev)
        start.record()
        rec = {"set": k, "events": [start], "logits": [], "kept": []}
        self._sink = rec if keep else None
        before = launch_counts()
        accs = self.evaluate(indices)
        self._sink = None
        rec["launches"] = {r: n - before[r] for r, n in launch_counts().items()}
        rec["accs"] = np.asarray(accs)
        if keep:
            self.records.append(rec)

    def warm(self) -> None:
        """Set-up: a call of ``warm_batches`` batches warms every shape the
        window uses (all its batches have one shape)."""
        self._run(0, batches=self.tr["warm_batches"], keep=False)

    def prime(self) -> None:
        """What the check needs before the window: nothing for an eval."""

    def call(self) -> None:
        self._run(len(self.records) % len(self.index_sets))

    def sub_call(self) -> None:
        self._run(0, batches=self.tr["subwindow_batches"], keep=False)

    def batch_ms(self) -> List[float]:
        return [a.elapsed_time(b) for r in self.records
                for a, b in zip(r["events"][:-1], r["events"][1:])]

    def free(self) -> None:
        del self.head
        if self._tf32 is not None:
            torch.backends.cuda.matmul.allow_tf32 = self._tf32
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def count_flops(self) -> float:
        """Model FLOPs of one batch, counted over the reference on the meta
        device at the cell's shapes."""
        from torch.utils.flop_counter import FlopCounterMode

        meta = {k: torch.empty(v.shape, device="meta") for k, v in self.encoder_params().items()}
        images = torch.empty((self.epb * self.way * self.n_per,) + tuple(self.images.shape[1:]),
                             dtype=torch.uint8, device="meta")
        with FlopCounterMode(display=False) as fc:
            self.reference_logits(images, Encoder(meta, self.enc_args))
        return float(fc.get_total_flops())

    def check(self, everything: bool = False) -> List[Check]:
        """The window's logits and per-episode accuracies against the
        reference's, over batches drawn from the seed. The numbers:

          * ``logit_gap``, ``logit_rms``, ``logit_mse``: the largest, the
            root-mean-square and the mean squared logit gap;
          * ``logit_vs_bf16``: the rms gap over that of the reference
            computed with bf16 products (only where a limit names it, or
            with ``everything``);
          * the numbers of the head's own stage (``stage_numbers``);
          * ``acc_outside``: episodes whose returned accuracy lies outside
            what the reference's logits allow. A query counts as decided
            where the reference's top two logits differ by more than twice
            the batch's largest gap (then both sides pick the same class);
            an episode's accuracy must lie between its decided right answers
            and those plus its undecided queries. Held to 0;
          * ``route_off``: on the card, the kernel launches of the window
            that differ from the traffic's ``launches_per_batch`` (a route
            the traffic does not name is held to none), summed over routes.
            Held to 0. Off the card the program launches nothing.

        The limits file names the numbers held to a limit."""
        pairs = [(i, b) for i, r in enumerate(self.records) for b in range(len(r["logits"]))]
        rng = inputs.host_rng(self.seed, 4)
        take = rng.choice(len(pairs), size=min(self.tr["check_batches"], len(pairs)),
                          replace=False)
        quant = self.tr["control"].get("reference_quant") if self.control else None
        with_bf16 = everything or "logit_vs_bf16" in self.limits
        labels = self.query_labels()
        enc = Encoder(self.encoder_params(), self.enc_args)
        gap, sq, sq16, count, outside = 0.0, 0.0, 0.0, 0, 0
        for t in sorted(take):
            i, b = pairs[t]
            rec = self.records[i]
            images = self.batch_images(self.index_sets[rec["set"]][b])
            with inputs.exact_fp32(), torch.no_grad():
                ref = self.reference_logits(images, enc).double()
                if quant:  # the control: the reference, rounded, takes the program's place
                    got = self.reference_logits(images, Encoder(
                        self.encoder_params(), self.enc_args, quant=quant)).double()
                    accs = (got.argmax(-1) == labels).double().mean(-1).cpu().numpy()
                else:
                    got = rec["logits"][b].double()
                    accs = rec["accs"][b * self.epb:(b + 1) * self.epb]
                if with_bf16:
                    r16 = self.reference_logits(images, Encoder(
                        self.encoder_params(), self.enc_args, compute=torch.bfloat16)).double()
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
        numbers.update(self.stage_numbers([pairs[t] for t in sorted(take)]))
        checks = [Check(k, v, float(self.limits.get(k, float("inf")))) for k, v in numbers.items()
                  if k in self.limits or everything]
        return checks + [Check("acc_outside", float(outside), 0.0),
                         Check("route_off", float(self.route_off()), 0.0)]

    def stage_numbers(self, pairs) -> Dict[str, float]:
        """Numbers of a stage checked on its own, over the (record, batch)
        pairs the check drew (with ``control``, the control's): none here."""
        return {}

    def route_off(self) -> int:
        want = self.tr.get("launches_per_batch", {}) if self.dev.type == "cuda" else {}
        off = 0
        for rec in self.records:
            n = len(rec["logits"])
            off += sum(abs(got - want.get(r, 0) * n) for r, got in rec["launches"].items())
        return off

    def readings(self) -> Dict[str, float]:
        """Every number ``check`` can compute, held to a limit or not."""
        limits = self.limits
        self.limits = {}
        try:
            return {c.name: c.value for c in self.check(everything=True)}
        finally:
            self.limits = limits

    def normalized(self, images_u8: torch.Tensor) -> torch.Tensor:
        return normalize(images_u8, self.mean, self.std)
