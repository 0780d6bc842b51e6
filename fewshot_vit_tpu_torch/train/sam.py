"""Sharpness-Aware Minimization, a two-pass step (counterpart:
``fewshot_vit_tpu/train/sam.py``).

Pass 1: the loss and its gradient g at w. Ascend to w + e(w), e = rho * g /
(||g|| + 1e-12), or with ``adaptive`` e = rho * w^2 * g / (|| |w| * g || +
1e-12). Pass 2: the gradient at w + e(w) is the update direction; the base
optimizer steps from the ORIGINAL w with it. The loss reported is the one at
w. Both passes draw the same dropout and drop-path masks (one generator key),
and the BN running statistics are those of pass 1, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..data.transforms import MEAN, STD
from ..ops.metric import compute_acc
from ..parallel.mesh import global_sq_norm, local_block, mean_metrics, sync_tensors
from .state import TrainState
from .steps import kept_bn_stats, step_inputs, train_forward


def _global_norm(tensors: Sequence[torch.Tensor], params) -> torch.Tensor:
    return torch.sqrt(global_sq_norm(tensors, params))


def sam_gradient(loss_fn: Callable[[bool], Tuple[torch.Tensor, object]],
                 params: List[torch.nn.Parameter], rho: float = 0.05,
                 adaptive: bool = False) -> Tuple[List[torch.Tensor], Tuple[torch.Tensor, object]]:
    """-> (sharpness-aware gradients, (loss, aux) of pass 1).

    ``loss_fn(first)`` computes ``(loss, aux)`` from the parameters' current
    values; ``first`` is False in pass 2. The parameters are perturbed in
    place for pass 2 and restored exactly afterwards. Under a mesh both
    passes' gradients are averaged over its ``data`` axis, and the norms
    are global."""
    def grads_of(loss):
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]
        sync_tensors(gs)
        return gs

    out1 = loss_fn(True)
    g1 = grads_of(out1[0])
    with torch.no_grad():
        if adaptive:
            scale = rho / (_global_norm([p.abs() * g for p, g in zip(params, g1)], params) + 1e-12)
            e_w = [scale * (p * p) * g for p, g in zip(params, g1)]
        else:
            scale = rho / (_global_norm(g1, params) + 1e-12)
            e_w = [scale * g for g in g1]
        original = [p.detach().clone() for p in params]
        for p, e in zip(params, e_w):
            p.add_(e)
    try:
        g2 = grads_of(loss_fn(False)[0])
    finally:
        with torch.no_grad():
            for p, w in zip(params, original):
                p.copy_(w)
    return g2, out1


def make_sam_pretrain_step(rho: float = 0.05, adaptive: bool = False, preprocess_fn=None,
                           mean=MEAN, std=STD) -> Callable:
    """The SAM variant of ``steps.make_pretrain_step``: two forward-backward
    passes per step, the same ``step(state, images_u8, labels, key)``."""

    def step(state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor, key):
        x = step_inputs(images_u8, key, preprocess_fn, mean, std)
        labels = local_block(labels.long())
        model = state.module.train()
        params = [p for p in model.parameters() if p.requires_grad]

        def loss_fn(first: bool):
            with contextlib.nullcontext() if first else kept_bn_stats(model):
                logits = train_forward(model, x, key)
            return F.cross_entropy(logits.float(), labels), logits

        grads, (loss, logits) = sam_gradient(loss_fn, params, rho, adaptive)
        for p, g in zip(params, grads):
            p.grad = g
        state.optimizer.step()
        state.step += 1
        return mean_metrics({"loss": loss.detach(),
                             "acc": compute_acc(logits.detach(), labels)})

    return step
