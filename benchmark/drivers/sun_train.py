"""Traffic ``sun_train``: SUN meta-training steps of
``fewshot_vit_tpu_torch.train.steps.make_sun_step`` with the device-side
dual view (``data.augment.make_dual_view_fn``), driven as
``train.loop.make_sun_epoch`` drives them: step i of the run gathers its
batch from the split on the card and takes the key (seed, epoch, i).

Set-up builds ONE training state (a token-label student, its AdamW and the
frozen teacher) and drives it through the first three steps, their
augmentation draws made by the benchmark and handed in as ``draws=``; their
losses, the teacher's patch logits and soft labels, the first gradient (from
AdamW's first moment after one step) and the parameters after three steps
are kept, and the same state goes on into the window. After the window the
reference runs those three steps from the same weights, batches and draws.

Thresholds turn rounding-sized gaps into large ones: the teacher's top-k
moves a label, and the augmentation's Equalize, Posterize and Solarize move
a pixel by many levels. So the reference follows the program stage by
stage from the program's own outputs, and each stage is checked apart:

  * the dual view against the reference's views of the same images and
    draws (``view_far``: the share of elements more than half a pixel level
    apart);
  * the teacher's patch logits on the program's weak view
    (``teacher_rel``: per image, the rms gap over the rms spread of the
    reference's logits about each patch's mean; the median over the images,
    since a few augmented images, Equalize's above all, magnify TF32's
    rounding many times over);
  * the soft labels against the labels the reference's rule gives the
    program's own logits (``label_mismatch``, exact);
  * the student on the program's strong view and labels: the first
    step's loss, the first gradient and the parameter change after three
    steps (``loss_gap``, ``grad_gap``, ``update_gap``). The later steps'
    losses are kept out: AdamW's first update is about the learning rate
    times the gradient's sign, so rounding flips it where a gradient is
    near zero and the two trajectories part by steps 2 and 3.

The traffic file gives the batch, the epoch whose learning rate the steps
run at, the dtypes of student and teacher, whether the teacher's attention
takes the fused kernel, and the control: ``{"tf32_matmul": true}`` (fp32
matmuls on TF32, as cuDNN's convolutions already are) or ``{"dtype":
"bfloat16"}``."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import inputs
from ..core import Check
from ..reference import augment as ref_aug
from ..reference import sun as ref_sun
from ..reference.heads import normalize
from ..reference.visformer import Encoder, param_shapes
from ..roofline import model_peak
from .common import encoder_args, tf32_matmul_on

CHECKED = 3
BETA1 = 0.9


def make_draws(seed: int, step: int, b: int, size: int, device) -> dict:
    """Every draw of one dual view over ``b`` images of ``size`` px, from the
    seed, with the distributions of the recipe."""
    gen = inputs.generator(device, seed, 5, step)
    rng = inputs.host_rng(seed, 5, step)
    u = lambda *s: torch.rand(s, generator=gen, device=device)
    bern = lambda p: u(b) < p
    layers = [{"op": int(rng.integers(len(ref_aug.OPS))),
               "mag": torch.clamp(9.0 + 0.5 * torch.randn(b, generator=gen, device=device), 0, 10),
               "sign": torch.where(bern(0.5), 1.0, -1.0), "apply": bern(0.5)} for _ in range(2)]
    return {
        "weak": {"crop": u(4, b), "flip": bern(0.5), "randaug": bern(0.2), "layers": layers},
        "strong": {"jitter": {"factors": 0.6 + 0.8 * u(3, b), "order": int(rng.integers(6))},
                   "blur": {"apply": bern(0.5), "sigma": 0.1 + 1.9 * u(b)},
                   "solarize": bern(0.5), "gray": bern(0.2), "strong": bern(0.5)},
        "erase": {"apply": bern(0.25), "target": (0.02 + (1 / 3 - 0.02) * u(b)) * size * size,
                  "log_r": np.log(0.3) + (np.log(1 / 0.3) - np.log(0.3)) * u(b),
                  "offsets": u(2, b),
                  "noise": torch.randn((b, size, size, 3), generator=gen, device=device)},
    }


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> List[float]:
    """Each leaf's |norm - reference norm| over the larger of the reference
    leaf's norm and the median leaf's."""
    med = float(np.median([ref[k] for k in keep]))
    return [abs(got[k] - ref[k]) / max(ref[k], med) for k in keep]


class Cell:
    kind, unit = "train", "images"

    def __init__(self, spec: dict, device, seed: int, control: bool = False,
                 fault: Optional[str] = None):
        cfg, tr = spec["config"], spec["traffic"]
        self.cfg, self.tr, self.limits = cfg, tr, spec["limits"]
        self.dev, self.seed, self.fault = device, int(seed), fault
        self.enc_args = encoder_args(cfg)
        self.mean, self.std = cfg["normalize"]["mean"], cfg["normalize"]["std"]
        self.sun = cfg["sun"]
        sp = cfg["split"]
        self.images = inputs.split(sp["classes"], sp["per_class"], sp["image_size"], seed, device)
        self.labels = torch.arange(sp["classes"], device=device).repeat_interleave(sp["per_class"])
        self.batch, self.epoch = tr["batch_size"], tr["epoch"]
        self.steps_per_pass = len(self.images) // self.batch
        self._order: Dict[int, np.ndarray] = {}
        n_cls = sp["classes"]
        shapes = {f"encoder.{k}": v for k, v in param_shapes(self.enc_args).items()}
        c = int(self.enc_args["embed_dim"]) * 2
        shapes.update({"classifier.linear.weight": (n_cls, c), "classifier.linear.bias": (n_cls,),
                       "classifier_local.linear.weight": (n_cls + 1, c),
                       "classifier_local.linear.bias": (n_cls + 1,)})
        self.teacher_params = inputs.weights(shapes, seed, device)
        enc = {k[len("encoder."):]: v for k, v in self.teacher_params.items()
               if k.startswith("encoder.")}
        rng = inputs.host_rng(seed, 3)
        pick = torch.from_numpy(np.sort(rng.choice(len(self.images), cfg["calibration_images"],
                                                   replace=False))).to(device)
        size, img = sp["image_size"], self.enc_args["img_size"]
        lo = (size - img) // 2
        crops = self.images[pick][:, lo:lo + img, lo:lo + img]
        inputs.calibrate(enc, self.enc_args, normalize(crops, self.mean, self.std))
        # the student starts from the teacher's encoder and global classifier
        # (the CLI's ``init_student_from_teacher``); its local classifier is its own
        local = inputs.weights({k: v for k, v in shapes.items() if k.startswith("classifier_local")},
                               seed, device, salt=6)
        self.student0 = {**{k: v.clone() for k, v in self.teacher_params.items()}, **local}
        self.dtype = tr["control"].get("dtype", tr["dtype"]) if control else tr["dtype"]
        self.peak_flops = model_peak(tr["dtype"])
        self.units_per_call, self.attempts_per_call = self.batch, 1
        fused = tr["teacher_fused_attention"]
        self.op_names = ("fewshot_vit_tpu_torch::fused_mhsa",) if fused else ()
        self.extra: Dict[str, object] = {}
        self.spans = None
        self.n_steps = 0
        self._draws = None
        self._tf32 = tf32_matmul_on() if control and tr["control"].get("tf32_matmul") else None
        self._build()
        self.flops_per_unit = self.count_flops() / self.batch

    # --- the program ------------------------------------------------------------
    def _build(self) -> None:
        from fewshot_vit_tpu_torch.core.config import Config
        from fewshot_vit_tpu_torch.core.registry import models
        from fewshot_vit_tpu_torch.data.augment import make_dual_view_fn
        from fewshot_vit_tpu_torch.heads import token_label  # noqa: F401  (registers)
        from fewshot_vit_tpu_torch.train import steps
        from fewshot_vit_tpu_torch.train.runner import build_optimizer
        from fewshot_vit_tpu_torch.train.state import TrainState

        n_cls = self.cfg["split"]["classes"]

        def make(dtype, state, pallas):
            m = models.make("token-label", encoder=self.cfg["encoder"],
                            encoder_args={**self.enc_args, "use_pallas_attn": pallas},
                            classifier_args={"n_classes": n_cls}, dtype=getattr(torch, dtype),
                            device=self.dev, seed=0)
            m.load_state_dict({k: v.clone() for k, v in state.items()}, strict=True)
            return m

        student = make(self.dtype, self.student0, False)
        self.teacher = make(self.dtype, self.teacher_params, self.tr["teacher_fused_attention"])
        self.teacher.requires_grad_(False).eval()
        opt = build_optimizer(Config({"optimizer": "adamw", "optimizer_args": self.cfg["optimizer"],
                                      "max_epoch": self.cfg["max_epoch"]}),
                              student.parameters(), self.batch)
        opt.set_epoch(self.epoch - 1)
        self.state = TrainState(student, opt)
        dual = make_dual_view_fn(self.mean, self.std, out_size=self.enc_args["img_size"],
                                 strong_prob=0.5)

        def augment(images_u8, generator):
            if self.spans is not None:
                self.spans._begin("augment")
            out = dual(images_u8, generator, draws=self._draws)
            if self.spans is not None:
                self.spans._end("augment")
            if self._draws is not None:  # a checked step: keep the views
                if self.fault == "token":  # one patch of every strong view altered
                    out = (out[0].clone(), out[1])
                    out[0][:, :16, :16] = 0.0
                self.views.append(tuple(v.detach() for v in out))
            return out

        self.step_fn = steps.make_sun_step(
            soft_k=self.sun["soft_k"], bg_tokens=self.sun["bg_tokens"],
            token_weight=self.sun["token_weight"], smoothing=self.sun["smoothing"],
            mean=self.mean, std=self.std, dual_view_fn=augment)
        if self.fault == "unchanged":
            opt.step = lambda: None
        elif self.fault == "half_batch":  # the loss's mean over the first half alone
            loss = steps.sun_loss

            def half(student, xs, labels, soft, *a, **k):
                n = xs.shape[0] // 2
                out = loss(student, xs[:n], labels[:n], soft[:n], *a, **k)
                return (*out[:3], out[3].repeat(2, 1))  # the accuracy metric wants B rows

            self._restore = (steps, "sun_loss", loss)
            steps.sun_loss = half

    def batch_rows(self, i: int) -> torch.Tensor:
        p = i // self.steps_per_pass
        if p not in self._order:
            self._order[p] = inputs.host_rng(self.seed, 3, p).permutation(len(self.images))
        j = (i % self.steps_per_pass) * self.batch
        return torch.from_numpy(self._order[p][j:j + self.batch]).to(self.dev)

    def _step(self) -> dict:
        rows = self.batch_rows(self.n_steps)
        imgs = self.images[rows]
        out = self.step_fn(self.state, self.teacher, imgs, imgs, self.labels[rows],
                           (self.seed, self.epoch, self.n_steps))
        self.n_steps += 1
        return out

    def warm(self) -> None:
        """The checked steps, then two more: every shape of the window warm."""
        self.prime()
        for _ in range(2):
            self._step()

    def prime(self) -> None:
        """The checked steps, their numbers kept for the check."""
        size = self.enc_args["img_size"]
        self.p0 = {n: p.detach().clone() for n, p in self.state.module.named_parameters()}
        self.draws = [make_draws(self.seed, i, self.batch, size, self.dev) for i in range(CHECKED)]
        from fewshot_vit_tpu_torch.train import steps

        losses, self.teacher_out, self.soft_out, self.views = [], [], [], []
        hook = self.teacher.register_forward_hook(
            lambda m, a, out: self.teacher_out.append(out[0].detach().float()))
        made = steps.sun_targets

        def kept(*a, **k):
            soft = made(*a, **k)
            self.soft_out.append(soft.detach().float())
            return soft

        steps.sun_targets = kept
        for i in range(CHECKED):
            self._draws = self.draws[i]
            losses.append(self._step()["loss"])
            if i == 0:
                st = self.state.optimizer.optimizer.state
                self.grad1 = {n: float(torch.linalg.vector_norm(st[p]["exp_avg"]) / (1 - BETA1))
                              if p in st else 0.0
                              for n, p in self.state.module.named_parameters()}
        self._draws = None
        steps.sun_targets = made
        hook.remove()
        self.losses = [float(x) for x in losses]
        self.change = {n: float(torch.linalg.vector_norm(p.detach() - self.p0[n]))
                       for n, p in self.state.module.named_parameters()}
        if self.fault == "half_batch":
            setattr(*self._restore)

    def call(self) -> None:
        self._step()

    def sub_call(self) -> None:
        for _ in range(2):
            self._step()

    def install_spans(self, spans) -> None:
        spans.module("teacher", self.teacher)
        self.spans = spans

    def batch_ms(self) -> List[float]:
        return []

    def free(self) -> None:
        del self.state, self.teacher, self.step_fn
        if self._tf32 is not None:
            torch.backends.cuda.matmul.allow_tf32 = self._tf32
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # --- the reference ----------------------------------------------------------
    def count_flops(self) -> float:
        """Model FLOPs of one step, counted over the reference on the meta
        device: the student's forward and backward, the teacher's forward."""
        from torch.utils.flop_counter import FlopCounterMode

        img = self.enc_args["img_size"]
        meta = {k: torch.empty(v.shape, device="meta", requires_grad=True)
                for k, v in self.student0.items() if "running" not in k}
        meta.update({k: torch.empty(v.shape, device="meta")
                     for k, v in self.student0.items() if "running" in k})
        x = torch.empty((self.batch, img, img, 3), device="meta")
        labels = torch.zeros(self.batch, dtype=torch.long, device="meta")
        with FlopCounterMode(display=False) as fc:
            soft = ref_sun.teacher_labels(meta, self.enc_args, x, self.sun)
            enc = Encoder(ref_sun.sub(meta, "encoder."), self.enc_args, bn="batch")
            dense, pooled = enc(x)
            b, h, w, c = dense.shape
            loss = torch.nn.functional.cross_entropy(
                ref_sun.linear(pooled, meta, "classifier"), labels)
            token = ref_sun.linear(dense.reshape(b, h * w, c), meta, "classifier_local")
            loss = loss + (-soft * token.log_softmax(-1)).sum(-1).mean()
            loss.backward()
        return float(fc.get_total_flops())

    def reference(self):
        """The reference's three steps on the program's labels: losses,
        first-gradient norms and parameter-change norms by leaf; and the
        teacher's and the labels' numbers."""
        params = {k: v.clone().requires_grad_("running" not in k) for k, v in self.student0.items()}
        names = [k for k in params if "running" not in k]
        o = self.cfg["optimizer"]
        base = o["lr"] * (self.batch / 512.0 if o.get("scale_lr_by_batch") else 1.0)
        lr = ref_sun.cosine_lr(self.epoch, base, self.cfg["max_epoch"], o["warmup_epochs"],
                               o.get("warmup_lr", 1e-6))
        opt = ref_sun.AdamW(lr, float(o["weight_decay"]))
        losses, grad1 = [], {}
        img = self.enc_args["img_size"]
        rel = []
        mismatch, far, elements = 0, 0, 0
        std = torch.as_tensor(self.std, dtype=torch.float64, device=self.dev) * 255.0
        for i in range(CHECKED):
            rows = self.batch_rows(i)
            imgs = self.images[rows]
            soft = self.soft_out[i]
            strong, weak = self.views[i]
            with inputs.exact_fp32():
                views = ref_aug.dual_view(imgs, self.draws[i], self.mean, self.std, img)
                for got, want in zip((strong, weak), views):
                    far += int((((got.double() - want) * std).abs() > 0.5).sum())
                    elements += got.numel()
                logits = ref_sun.teacher_logits(self.teacher_params, self.enc_args, weak.float())
                got = self.teacher_out[i].reshape(logits.shape)
                gap = ((got - logits) ** 2).sum(dim=(1, 2))
                spread = ((logits - logits.mean(-1, keepdim=True)) ** 2).sum(dim=(1, 2))
                rel.append(torch.sqrt(gap / spread))
                rule = ref_sun.soft_labels(got, self.sun["smoothing"], self.sun["soft_k"],
                                           self.sun["bg_tokens"])
                # on and off differ by 0.9; the program sums them, so 1e-6 of room
                mismatch += int(((rule - soft).abs() > 1e-6).any(-1).sum())
                loss = ref_sun.student_loss(params, self.enc_args, strong.float(),
                                            self.labels[rows], soft,
                                            (self.seed, self.epoch, i), self.sun)
                grads = torch.autograd.grad(loss, [params[k] for k in names])
            losses.append(float(loss.detach()))
            if i == 0:
                grad1 = {k: float(torch.linalg.vector_norm(g)) for k, g in zip(names, grads)}
            opt.step(params, dict(zip(names, grads)))
        change = {k: float(torch.linalg.vector_norm(params[k].detach() - self.student0[k]))
                  for k in names}
        return (losses, grad1, change, float(torch.cat(rel).median()), mismatch,
                far / elements)

    def check(self, everything: bool = False) -> List[Check]:
        """Leaves whose reference gradient is under a thousandth of the
        median leaf's move by round-off alone and are left out of the leaf
        gaps."""
        losses, grad1, change, teacher_rel, mismatch, view_far = self.reference()
        med = float(np.median(list(grad1.values())))
        keep = [k for k, g in grad1.items() if g >= 1e-3 * med]
        numbers = {
            "view_far": view_far,
            "teacher_rel": teacher_rel,
            "loss_gap": abs(self.losses[0] - losses[0]) / abs(losses[0]),
            "update_gap": max(leaf_gaps(self.change, change, keep)),
        }
        gaps = leaf_gaps(self.grad1, grad1, keep)
        numbers["grad_gap"] = max(gaps)
        numbers["grad_med"] = float(np.median(gaps))  # reported, not compared
        checks = [Check(k, v, float(self.limits.get(k, float("inf")))) for k, v in numbers.items()
                  if k in self.limits or everything]
        return checks + [Check("label_mismatch", float(mismatch), 0.0)]

    def readings(self) -> Dict[str, float]:
        return {c.name: c.value for c in self.check(everything=True)}
