"""Traffic ``emd_sfc_eval``: k-shot SUN-D (DeepEMD) episodes whose
prototypes SFC refines before the matching, scored by
``fewshot_vit_tpu_torch.eval.emd_eval.evaluate_emd`` with the traffic's
``sfc`` (``steps``, ``lr``, ``batch_size``) as its ``sfc_kw``; otherwise
``emd_eval``.

The reference (``reference/sfc.py``) refines its own prototypes, from its
own nodes, with the program's shuffle orders injected: each checked batch's
episodes keep their global indices in the call, and the program's
``heads.deepemd.sfc_perms`` gives their orders from those indices and the
program's seed, as the program draws them. Every SFC step does the same
work, so ``count_flops`` counts the reference at no step and at one and
scales the step to the configured number. The fault ``sfc_half_steps`` runs
the program's SFC for half its steps.

The traced sub-window's batches refine for ``trace_sfc_steps`` steps: a
step launches about 42,000 operations (7 mini-batches, each a 100-iteration
torch-op Sinkhorn and its backward), so a profiler trace of a whole
100-step batch holds millions of events, gigabytes of trace. Its encoder,
head and kernel numbers are those of a whole batch; its idle share is that
of a batch with this shorter SFC."""

from __future__ import annotations

import numpy as np
import torch

from ..reference.heads import emd_logits, grid_patches
from ..reference.sfc import refine
from . import emd_eval

CHUNK = emd_eval.CHUNK


class Cell(emd_eval.Cell):

    def __init__(self, spec: dict, device, seed: int, control: bool = False, fault=None):
        self.sfc = dict(spec["traffic"]["sfc"])
        self.ref_steps = int(self.sfc["steps"])  # the steps the reference takes
        self.first_id = 0  # global index of the first episode of the batch being checked
        self.traced = False
        super().__init__(spec, device, seed, control, fault)
        self.first_ids = {s[b].tobytes(): b * self.epb for s in self.index_sets
                          for b in range(len(s))}

    def program_sfc(self) -> dict:
        kw = dict(self.sfc)
        if self.traced:
            kw["steps"] = int(self.tr["trace_sfc_steps"])
        elif self.fault == "sfc_half_steps":
            kw["steps"] = int(kw["steps"]) // 2
        return kw

    def sub_call(self) -> None:
        self.traced = True
        try:
            super().sub_call()
        finally:
            self.traced = False

    def evaluate(self, indices: np.ndarray):
        from fewshot_vit_tpu_torch.eval.emd_eval import evaluate_emd

        flat = indices.reshape(-1, indices.shape[-1])
        _, _, accs = evaluate_emd(
            self.head, self.dataset, way=self.way, shot=self.shot, query=self.query,
            n_episodes=len(flat), ep_per_batch=self.epb, mode=self.cfg["deepemd"], cached=False,
            indices=flat, patch_list=self.cfg["patch_list"],
            patch_ratio=float(self.cfg["patch_ratio"]), image_size=self.enc_args["img_size"],
            sfc_kw=self.program_sfc(), images_dev=self.images, device=self.dev)
        return accs

    def batch_images(self, indices: np.ndarray) -> torch.Tensor:
        self.first_id = self.first_ids[np.asarray(indices).tobytes()]
        return super().batch_images(indices)

    def perms(self, device) -> torch.Tensor:
        """The program's shuffle orders of the batch's episodes, the
        reference's steps of them."""
        from fewshot_vit_tpu_torch.core.rng import DEFAULT_SEED
        from fewshot_vit_tpu_torch.heads.deepemd import sfc_perms

        ids = range(self.first_id, self.first_id + self.epb)
        return sfc_perms(ids, self.ref_steps, self.way * self.shot, DEFAULT_SEED).to(device)

    def count_flops(self) -> float:
        steps = self.ref_steps
        try:
            self.ref_steps = 0
            base = super().count_flops()
            self.ref_steps = 1
            one = super().count_flops()
        finally:
            self.ref_steps = steps
        return base + steps * (one - base)

    def reference_logits(self, images_u8, enc):
        size = self.enc_args["img_size"]
        nodes = []
        for s in range(0, images_u8.shape[0], CHUNK // 16):
            patches = grid_patches(images_u8[s:s + CHUNK // 16], self.cfg["patch_list"],
                                   float(self.cfg["patch_ratio"]), size)
            n = patches.shape[1]
            pooled = enc(self.normalized(patches.reshape(-1, *patches.shape[2:])))[1]
            nodes.append(pooled.reshape(-1, n, pooled.shape[-1]))
        nodes = torch.cat(nodes).reshape(self.epb, self.way * self.n_per, -1, nodes[0].shape[-1])
        k = self.way * self.shot
        temperature, reg = float(self.cfg["temperature"]), float(self.cfg["solver_reg"])
        iters = int(self.cfg["solver_iters"])
        proto = nodes[:, :k].reshape(self.epb, self.shot, self.way, *nodes.shape[2:]).mean(1)
        proto = refine(proto, nodes[:, :k], self.perms(nodes.device), self.way,
                       float(self.sfc["lr"]), int(self.sfc["batch_size"]), temperature, reg,
                       iters)
        return emd_logits(proto, nodes[:, k:], temperature, reg, iters)
