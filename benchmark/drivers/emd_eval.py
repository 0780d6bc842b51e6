"""Traffic ``emd_eval``: SUN-D (DeepEMD) episodes scored by
``fewshot_vit_tpu_torch.eval.emd_eval.evaluate_emd``, every image
re-encoded (not cached).

The configuration gives the patch pipeline (``deepemd``, ``patch_list``,
``patch_ratio``) and the matching (``temperature``, ``solver_reg``,
``solver_iters``); the traffic file the episode geometry, the episodes a
call and a batch, the solver, the compute dtype, whether the fused attention kernel is on, and
the lower-precision control ``{"reference_quant": "fp8"}``: the program has
no int8 or fp8 path for this head, so the reference computed in fp8 takes
its place.

Beside the logits, the head is checked as a stage of its own: the window
keeps each batch's prototype and query nodes (the encoder's output, as the
head's matching gets them) and the flows its solver returned, and the
reference recomputes from those nodes the marginals, the cost and the
flows in float64 (``flow_rel``: the rms gap of the flows over their rms,
over the checked batches). The head's matching runs in fp32 whatever the
encoder's dtype, so its control is the reference's matching in bf16 on the
same nodes, put in the solver's place. The fault ``iters_<n>`` runs the
program's solver for n iterations instead of the configured number."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .. import inputs
from ..reference.heads import emd_flow, emd_logits, grid_patches
from .common import EpisodeCell

CHUNK = 1024  # reference patch images at a time


class Cell(EpisodeCell):
    op_names = ("fewshot_vit_tpu_torch::fused_mhsa", "fewshot_vit_tpu_torch::sinkhorn_pallas")

    def layout(self, eps: np.ndarray) -> np.ndarray:
        """(episodes, way, n_per) -> (batches, epb, way * n_per) in the
        interleaved layout: item t of class w at t * way + w, shots first."""
        return eps.transpose(0, 2, 1).reshape(self.n_batches, self.epb, -1)

    def build(self):
        from fewshot_vit_tpu_torch.core.registry import models
        from fewshot_vit_tpu_torch.heads import deepemd  # (registers)

        tr = self.tr
        iters = int(self.cfg["solver_iters"])
        if self.fault and self.fault.startswith("iters_"):
            iters = int(self.fault[len("iters_"):])
        head = models.make("deepemd", encoder=self.cfg["encoder"],
                           encoder_args={**self.enc_args, "use_pallas_attn": tr["use_pallas_attn"]},
                           temperature=self.cfg["temperature"], solver_reg=self.cfg["solver_reg"],
                           solver_iters=iters, solver=tr["solver"],
                           dtype=getattr(torch, self.dtype), device=self.dev, seed=0)
        head.load_state_dict(self.state_dict(), strict=True)
        self.dataset = SimpleNamespace(mean=np.asarray(self.mean, np.float32),
                                       std=np.asarray(self.std, np.float32))
        meta, distance = head.meta, deepemd.emd_distance
        self._restore = (deepemd, "emd_distance", distance)

        def distance_kept(sim, flow, temperature):
            self._flow = flow
            return distance(sim, flow, temperature)

        def meta_kept(proto, query):
            self._flow = None
            out = meta(proto, query)
            if self._sink is not None:
                self._sink["kept"].append((proto, query, self._flow))
            self._after_batch(None, None, out)
            return out

        deepemd.emd_distance = distance_kept
        head.meta = meta_kept
        return head

    def free(self) -> None:
        setattr(*self._restore)
        super().free()

    def capture(self) -> None:
        pass  # the head's matching is wrapped in ``build``

    def install_spans(self, spans) -> None:
        spans.module("encoder", self.head.encoder)
        self.head.meta = spans.wrap("emd_head", self.head.meta)

    def evaluate(self, indices: np.ndarray):
        from fewshot_vit_tpu_torch.eval.emd_eval import evaluate_emd

        flat = indices.reshape(-1, indices.shape[-1])
        _, _, accs = evaluate_emd(
            self.head, self.dataset, way=self.way, shot=self.shot, query=self.query,
            n_episodes=len(flat), ep_per_batch=self.epb, mode=self.cfg["deepemd"], cached=False,
            indices=flat, patch_list=self.cfg["patch_list"],
            patch_ratio=float(self.cfg["patch_ratio"]), image_size=self.enc_args["img_size"],
            images_dev=self.images, device=self.dev)
        return accs

    def stage_numbers(self, pairs):
        """``flow_rel`` over the checked batches: the flows the program's
        solver returned (the control's: the reference's in bf16) against the
        reference's flows from the same nodes."""
        gap = total = 0.0
        reg, iters = float(self.cfg["solver_reg"]), int(self.cfg["solver_iters"])
        with inputs.exact_fp32(), torch.no_grad():
            for i, b in pairs:
                proto, query, flow = self.records[i]["kept"][b]
                _, ref = emd_flow(proto, query, reg, iters)
                if self.control:
                    flow = emd_flow(proto, query, reg, iters, torch.bfloat16)[1]
                gap += float(((flow.double() - ref) ** 2).sum())
                total += float((ref * ref).sum())
        return {"flow_rel": (gap / total) ** 0.5} if total > 0 else {}

    def batch_images(self, indices: np.ndarray) -> torch.Tensor:
        idx = torch.from_numpy(np.asarray(indices, np.int64).reshape(-1)).to(self.images.device)
        return self.images[idx]

    def query_labels(self) -> torch.Tensor:
        return torch.arange(self.way, device=self.dev).repeat(self.query)

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
        proto = nodes[:, :k].reshape(self.epb, self.shot, self.way, *nodes.shape[2:]).mean(1)
        return emd_logits(proto, nodes[:, k:], float(self.cfg["temperature"]),
                          float(self.cfg["solver_reg"]), int(self.cfg["solver_iters"]))
