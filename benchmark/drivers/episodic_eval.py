"""Traffic ``episodic_eval``: Meta-Baseline episodes scored by
``fewshot_vit_tpu_torch.eval.episodic.evaluate``, every image re-encoded.

The traffic file gives the episode geometry (way, shot, query), the episodes
a call and a batch, the compute dtype, whether BN is folded into the convs
at set-up and whether the fused attention kernel is on, and the
lower-precision control: ``{"int8": true}`` (the program's int8 encoder,
``models/quant.py``, calibrated on the calibration images),
``{"tf32_matmul": true}`` (fp32 matmuls on TF32, as cuDNN's convolutions
already are) or ``{"dtype": "bfloat16"}``."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..reference.heads import cosine_logits
from .common import EpisodeCell

CHUNK = 1024  # reference images at a time


class Cell(EpisodeCell):
    op_names = ("fewshot_vit_tpu_torch::fused_mhsa",)

    def head_shapes(self):
        return {"temp": ()}

    def layout(self, eps: np.ndarray) -> np.ndarray:
        """(episodes, way, n_per) -> (batches, epb * way * n_per): episode-
        major, class-major, shots first within a class."""
        return eps.reshape(self.n_batches, -1)

    def build(self):
        from fewshot_vit_tpu_torch.core.registry import models
        from fewshot_vit_tpu_torch.heads import meta_baseline  # noqa: F401  (registers)
        from fewshot_vit_tpu_torch.models.fold import fold_encoder_in_head
        from fewshot_vit_tpu_torch.models.quant import quantize_encoder_in_head

        control = self.tr["control"] if self.control else {}
        dtype = getattr(torch, control.get("dtype", self.dtype))
        head = models.make("meta-baseline", encoder=self.cfg["encoder"],
                           encoder_args={**self.enc_args,
                                         "use_pallas_attn": self.tr["use_pallas_attn"]},
                           method="cos", dtype=dtype, device=self.dev, seed=0)
        head.load_state_dict(self.state_dict(), strict=True)
        if control.get("int8"):
            head = quantize_encoder_in_head(head, calib_images=self.normalized(self.calib_images))
        elif self.tr["fold_bn"]:
            head = fold_encoder_in_head(head)
        self.temp = float(self.params["temp"])
        self.dataset = SimpleNamespace(mean=np.asarray(self.mean, np.float32),
                                       std=np.asarray(self.std, np.float32))
        return head

    def install_spans(self, spans) -> None:
        spans.module("encoder", self.head.encoder)

    def evaluate(self, indices: np.ndarray):
        from fewshot_vit_tpu_torch.eval.episodic import evaluate

        _, _, accs = evaluate(self.head, self.dataset, n_episodes=len(indices) * self.epb,
                              way=self.way, shot=self.shot, query=self.query,
                              ep_per_batch=self.epb, images_dev=self.images, indices=indices,
                              device=self.dev)
        return accs

    def batch_images(self, indices: np.ndarray) -> torch.Tensor:
        return self.images[torch.from_numpy(np.asarray(indices, np.int64)).to(self.images.device)]

    def query_labels(self) -> torch.Tensor:
        return torch.arange(self.way, device=self.dev).repeat_interleave(self.query)

    def reference_logits(self, images_u8, enc):
        pooled = torch.cat([enc(self.normalized(images_u8[s:s + CHUNK]))[1]
                            for s in range(0, images_u8.shape[0], CHUNK)])
        f = pooled.reshape(self.epb, self.way, self.n_per, -1)
        proto = f[:, :, :self.shot].mean(dim=2)
        query = f[:, :, self.shot:].reshape(self.epb, self.way * self.query, -1)
        return cosine_logits(query, proto, self.temp)
