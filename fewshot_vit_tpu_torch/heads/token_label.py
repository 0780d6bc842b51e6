"""SUN token-label student / teacher head and its research variants
(counterpart: ``fewshot_vit_tpu/heads/token_label.py``).

  * ``TokenLabel``: encoder + global classifier (C classes, on the pooled
    feature) + local token classifier (C + 1 classes, background included,
    on every patch of the dense map). ``is_teacher=True`` sends the dense
    map through the GLOBAL classifier: the teacher labels patches with base
    classes only. Token logits stay NHWC (B, H, W, C').
  * ``token-label-ep``: episodic eval combining dense top-1 local cosine
    similarity with global cosine prototype logits (temp 10);
  * ``token-label-ep-rw``, ``-ep-cr``: the reference's position-aligned
    episodic heads, with learned task/class reweighting or a per-class
    (C, C) channel attention;
  * ``token-label-v2``: the SUN student with 3-layer projection MLPs.

The reference code of the episodic variants does not run as written; each
class's docstring names the fix it takes, as the JAX package's does. All
four return tuples, so ``standard_episodic = False``: no trainer drives them.
Episodes: x_shot (E, way, shot, H, W, 3), x_query (E, Q, H, W, 3).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.registry import models
from ..models.common import Linear, init_weights
from ..ops.metric import compute_logits, l2_normalize
from .classifier import LinearClassifier


class TokenLabel(nn.Module):
    # whole-classification signature, not the episodic (x_shot, x_query) one
    standard_episodic = False

    def __init__(self, encoder: nn.Module, n_classes: int, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed + 1)
        self.encoder = encoder
        self.n_classes = n_classes
        self.classifier = LinearClassifier(encoder.out_dim, n_classes, dtype, gen)
        self.classifier_local = LinearClassifier(encoder.out_dim, n_classes + 1, dtype, gen)

    def forward(self, x: torch.Tensor, is_teacher: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (token logits (B, H, W, C or C + 1), global logits (B, C), pooled)."""
        dense, pooled = self.encoder(x)
        y_token = self.classifier(dense) if is_teacher else self.classifier_local(dense)
        return y_token, self.classifier(pooled), pooled


class TokenLabelEpisodic(nn.Module):
    """``token-label-ep``: (local_logits, cls_logits), each (E, Q, way).
    local = per query patch, the best cosine match over ALL support patches
    of a class, averaged over query patches; cls = cosine prototype logits
    at ``temp``. This is the documented intent of the reference head, whose
    code fails at every input rank; the JAX package gives the reasons."""

    standard_episodic = False

    def __init__(self, encoder: nn.Module, temp: float = 10.0):
        super().__init__()
        self.encoder = encoder
        self.temp = temp

    def forward(self, x_shot: torch.Tensor, x_query: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        fs, fq, ps, pq = _encode_episode(self.encoder, x_shot, x_query)
        e, way, shot, t, c = fs.shape
        sim = torch.einsum("eqtc,enkc->eqntk", l2_normalize(fq),
                           l2_normalize(fs.reshape(e, way, shot * t, c)))  # (E, Q, way, T, shot*T)
        return sim.amax(dim=-1).mean(dim=-1), compute_logits(pq, ps.mean(dim=2), "cos", self.temp)


def _cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``torch.cosine_similarity(dim=-1)`` as the reference computes it, with
    broadcasting: sum(a*b) / max(||a|| * ||b||, eps)."""
    num = torch.sum(a * b, dim=-1)
    den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
    return num / den.clamp_min(eps)


def _encode_episode(encoder: nn.Module, x_shot: torch.Tensor, x_query: torch.Tensor):
    """One encoder pass over shots and queries -> fp32 ``fs (E, way, shot,
    T, C), fq (E, Q, T, C), ps (E, way, shot, C'), pq (E, Q, C')``. Tokens
    are row-major over (H, W), the reference's NCHW ``view(c, h*w)`` order."""
    e, way, shot = x_shot.shape[:3]
    q = x_query.shape[1]
    img = x_shot.shape[3:]
    dense, pooled = encoder(torch.cat([x_shot.reshape(-1, *img), x_query.reshape(-1, *img)]))
    c = dense.shape[-1]
    t = dense.shape[1] * dense.shape[2]
    n_shot = e * way * shot
    fs = dense[:n_shot].reshape(e, way, shot, t, c).float()
    fq = dense[n_shot:].reshape(e, q, t, c).float()
    ps = pooled[:n_shot].reshape(e, way, shot, -1).float()
    pq = pooled[n_shot:].reshape(e, q, -1).float()
    return fs, fq, ps, pq


def _aligned_local_logits(fq: torch.Tensor, fs: torch.Tensor) -> torch.Tensor:
    """Position-aligned local matching: fq (E, Q, n|1, T, C) against fs (E,
    way, shot, T, C) -> (E, Q, way): the cosine of query token i with
    support token i, the best position, the mean over shots (the intent
    the reference's shape comments pin; its code keeps one class axis too
    few)."""
    sim = _cosine(fq[:, :, :, None], fs[:, None])  # (E, Q, way, shot, T)
    return sim.amax(dim=-1).mean(dim=-1)


def _cls_logits(ps: torch.Tensor, pq: torch.Tensor, temp: float) -> torch.Tensor:
    """The shared global branch: cosine of the pooled query against the
    shot-mean prototype at ``temp``."""
    return compute_logits(l2_normalize(pq), l2_normalize(ps.mean(dim=2)), "dot", temp)


class _BottleneckMLP(nn.Module):
    """``fc1 (dim -> hidden) -> ReLU -> fc2 (hidden -> out)``, fp32 (the
    reference's ``intra_task/class_learner``)."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden, True, init="lecun")
        self.fc2 = Linear(hidden, out, True, init="lecun")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class TokenLabelEpisodicReweight(nn.Module):
    """``token-label-ep-rw``: episodic local matching with learned task and
    class reweighting. The reference constructor reads undefined globals
    ``dim`` / ``ratio``: here ``dim`` is the encoder width and ``ratio`` 4,
    as the same file's ``MetaLearner``. Two knowing departures at the
    reference's bug sites, as in JAX: ``logits_reweight`` really uses the
    reweighted features, and the class axis is kept. The unused classifier
    heads of the reference constructor are left out.

    Returns ``(logits, logits_reweight, cls_logits, cls_logits_reweight)``,
    each (E, Q, way)."""

    standard_episodic = False

    def __init__(self, encoder: nn.Module, ratio: int = 4, temp: float = 10.0, seed: int = 0):
        super().__init__()
        self.encoder = encoder
        self.temp = temp
        c = encoder.out_dim
        self.intra_task_learner = _BottleneckMLP(c, c * ratio, c)
        self.intra_class_learner = _BottleneckMLP(c, c * ratio, c)
        gen = torch.Generator().manual_seed(seed + 1)
        init_weights(self.intra_task_learner, gen)
        init_weights(self.intra_class_learner, gen)

    def forward(self, x_shot: torch.Tensor, x_query: torch.Tensor):
        fs, fq, ps, pq = _encode_episode(self.encoder, x_shot, x_query)
        # the task kernel: the mean over every support token; the class
        # weights: a per-class channel sigmoid gate
        w_task = self.intra_task_learner(fs.mean(dim=(1, 2, 3)))          # (E, C)
        w_class = torch.sigmoid(self.intra_class_learner(fs.mean(dim=(2, 3))))  # (E, way, C)
        # channel reweight, then the spatial saliency map of the task kernel
        fq_rw = fq[:, :, None] * w_class[:, None, :, None]                # (E, Q, way, T, C)
        fs_rw = fs * w_class[:, :, None, None]                            # (E, way, shot, T, C)
        map_q = torch.sigmoid(torch.einsum("eqntc,ec->eqnt", fq_rw, w_task))
        map_s = torch.sigmoid(torch.einsum("enktc,ec->enkt", fs_rw, w_task))
        fq_rw = fq_rw * map_q[..., None]
        fs_rw = fs_rw * map_s[..., None]

        logits = _aligned_local_logits(fq[:, :, None], fs)
        logits_rw = _aligned_local_logits(fq_rw, fs_rw)
        cls_logits = _cls_logits(ps, pq, self.temp)
        # l2-normalized token-mean reweighted features, no temperature
        x_s = l2_normalize(fs_rw.mean(dim=(2, 3)))                        # (E, way, C)
        x_q = l2_normalize(fq_rw.mean(dim=3))                             # (E, Q, way, C)
        cls_logits_rw = torch.einsum("eqnc,enc->eqn", x_q, x_s)
        return logits, logits_rw, cls_logits, cls_logits_rw


class TokenLabelEpisodicChannelAttn(nn.Module):
    """``token-label-ep-cr``: each query's channels mixed by a (C, C)
    attention against each class's support tokens, then aligned local
    matching. For shot > 1 the query tokens are tiled across shots (the
    intent of the reference's 1-shot-only ``expand``), which collapses to
    one contraction over (shot, token) without the tiled tensor. The
    attention is (E, Q, way, C, C): 1.6 GB in fp32 at C 512, E 4, Q 75.

    Returns ``(logits, cls_logits)``, each (E, Q, way)."""

    standard_episodic = False

    def __init__(self, encoder: nn.Module, temp: float = 10.0):
        super().__init__()
        self.encoder = encoder
        self.temp = temp

    def forward(self, x_shot: torch.Tensor, x_query: torch.Tensor):
        fs, fq, ps, pq = _encode_episode(self.encoder, x_shot, x_query)
        _, _, shot, t, _ = fs.shape
        attn = torch.einsum("eqic,ensid->eqncd", fq, fs)
        attn = torch.softmax(attn / float(shot * t) ** 0.5, dim=-1)
        fq_attn = torch.einsum("eqtj,eqnij->eqnti", fq, attn)            # feat_query @ attn^T
        return _aligned_local_logits(fq_attn, fs), _cls_logits(ps, pq, self.temp)


class TokenLabelV2(nn.Module):
    """``token-label-v2``: the SUN student with a 3-layer projection MLP on
    the dense map (``projection_0/2/4``) and a 3-layer local head to a
    ``dim``-d token embedding (``classifier_local_0/2/4``). The dense map and
    the pooled feature are scaled by 1/sqrt(C) first. The reference passes
    a list to ``nn.Sequential``; with varargs it runs, and this is that.

    Returns ``(y_token (B, H, W, dim), y (B, n_classes), pooled_scaled (B, C),
    y_projection (B, H, W, C))``, computed in ``dtype``."""

    standard_episodic = False

    def __init__(self, encoder: nn.Module, n_classes: int, dim: int = 128,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.encoder = encoder
        c = encoder.out_dim
        for name, widths in (("projection", (c, c, c)), ("classifier_local", (c, c, dim))):
            cin = c
            for i, w in enumerate(widths):
                setattr(self, f"{name}_{2 * i}", Linear(cin, w, True, dtype, init="lecun"))
                cin = w
        gen = torch.Generator().manual_seed(seed + 1)
        for name, m in self.named_children():
            if name != "encoder":
                init_weights(m, gen)
        self.classifier = LinearClassifier(c, n_classes, dtype, gen)

    def _mlp3(self, x: torch.Tensor, name: str) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"{name}_{2 * i}")(x)
            if i < 2:
                x = torch.relu(x)
        return x

    def forward(self, x: torch.Tensor):
        dense, pooled = self.encoder(x)
        scale = 1.0 / float(dense.shape[-1]) ** 0.5
        dense = dense * scale
        pooled = pooled * scale
        y_proj = self._mlp3(dense, "projection")
        y_token = self._mlp3(y_proj, "classifier_local")
        return y_token, self.classifier(pooled), pooled, y_proj


@models.register("token-label")
def make_token_label(
    encoder: str,
    encoder_args: Optional[dict] = None,
    classifier_args: Optional[dict] = None,
    dtype: torch.dtype = torch.float32,
    device: Any = "cuda",
    seed: int = 0,
) -> TokenLabel:
    device = resolve_device(device)
    enc = models.make(encoder, dtype=dtype, device=device, seed=seed, **(encoder_args or {}))
    n_classes = int(dict(classifier_args or {})["n_classes"])
    return TokenLabel(enc, n_classes, dtype, seed).to(device).eval()


def _encoder(encoder, encoder_args, dtype, device, seed):
    return models.make(encoder, dtype=dtype, device=device, seed=seed, **(encoder_args or {}))


@models.register("token-label-ep")
def make_token_label_ep(encoder: str, encoder_args: Optional[dict] = None, temp: float = 10.0,
                        dtype: torch.dtype = torch.float32, device: Any = "cuda", seed: int = 0,
                        **_: Any) -> TokenLabelEpisodic:
    device = resolve_device(device)
    enc = _encoder(encoder, encoder_args, dtype, device, seed)
    return TokenLabelEpisodic(enc, temp).to(device).eval()


@models.register("token-label-ep-rw")
def make_token_label_ep_rw(encoder: str, encoder_args: Optional[dict] = None, ratio: int = 4,
                           temp: float = 10.0, dtype: torch.dtype = torch.float32,
                           device: Any = "cuda", seed: int = 0,
                           **_: Any) -> TokenLabelEpisodicReweight:
    device = resolve_device(device)
    enc = _encoder(encoder, encoder_args, dtype, device, seed)
    return TokenLabelEpisodicReweight(enc, ratio, temp, seed).to(device).eval()


@models.register("token-label-ep-cr")
def make_token_label_ep_cr(encoder: str, encoder_args: Optional[dict] = None, temp: float = 10.0,
                           dtype: torch.dtype = torch.float32, device: Any = "cuda",
                           seed: int = 0, **_: Any) -> TokenLabelEpisodicChannelAttn:
    device = resolve_device(device)
    enc = _encoder(encoder, encoder_args, dtype, device, seed)
    return TokenLabelEpisodicChannelAttn(enc, temp).to(device).eval()


@models.register("token-label-v2")
def make_token_label_v2(encoder: str, encoder_args: Optional[dict] = None,
                        classifier: str = "linear-classifier",
                        classifier_args: Optional[dict] = None, dim: int = 128,
                        dtype: torch.dtype = torch.float32, device: Any = "cuda", seed: int = 0,
                        **_: Any) -> TokenLabelV2:
    if classifier != "linear-classifier":
        raise ValueError("token-label-v2 head supports linear-classifier only")
    device = resolve_device(device)
    n_classes = int(dict(classifier_args or {})["n_classes"])
    enc = _encoder(encoder, encoder_args, dtype, device, seed)
    return TokenLabelV2(enc, n_classes, dim, dtype, seed).to(device).eval()
