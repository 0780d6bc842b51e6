"""Frozen-BN folding over the port's weights (counterpart:
``fewshot_vit_tpu/models/fold.py``).

In eval mode every BatchNorm is the fixed per-channel affine
y = x * m + t, m = weight / sqrt(running_var + eps), t = bias - running_mean * m,
which folds exactly into an adjacent conv or Linear (same float64 math as the
JAX package, cast to float32):

  * BN after a conv / Linear: scale the OUT axis,
    weight' = weight * m[:, None, ...], bias' = bias * m + t;
  * BN before a 1x1 conv (Visformer's block pre-norms feeding ``attn.qkv``
    and ``mlp.conv1``): scale the IN axis,
    weight' = weight * m[None, :, None, None], bias' = bias + weight[:, :, 0, 0] @ t.

Families (JAX's ``_FOLDERS``): Visformer (the stem, the patch embeds and the
block pre-norms; the final ``norm`` has no adjacent conv and stays), LeViT
(the stem and every ``LinearNorm``; no BN survives) and ResNet-12 (each
block's four conv + BN pairs; no BN survives).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .common import BN_EPS

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")

# BN key prefix -> (conv / Linear prefix, BN-after-it?), or None where the BN stays
FoldRule = Callable[[str], Optional[Tuple[str, bool]]]


def _stem_rule(bn: str, stem: str) -> Optional[Tuple[str, bool]]:
    """The residual conv stem's pairs (Visformer's ConvStem, a ResNet-12
    block): ``bn{i}`` after ``conv{i}``, ``downsample.1`` after ``.0``."""
    if bn == f"{stem}.downsample.1":
        return f"{stem}.downsample.0", True
    m = re.fullmatch(rf"{re.escape(stem)}\.bn(\d)", bn)
    return (f"{stem}.conv{m[1]}", True) if m else None


def _visformer_rule(bn: str) -> Optional[Tuple[str, bool]]:
    if bn == "norm.bn":
        return None
    rule = _stem_rule(bn, "stem")
    if rule:
        return rule
    m = re.fullmatch(r"(patch_embed\d)\.norm\.bn", bn)
    if m:
        return f"{m[1]}.proj", True
    m = re.fullmatch(r"(stage\d\.\d+)\.norm([12])\.bn", bn)
    if m:
        return f"{m[1]}.{'attn.qkv' if m[2] == '1' else 'mlp.conv1'}", False
    raise KeyError(f"no fold rule for BatchNorm {bn!r}")


def _levit_rule(bn: str) -> Optional[Tuple[str, bool]]:
    rule = _stem_rule(bn, "patch_embed")
    if rule:
        return rule
    if bn.endswith(".bn"):  # a LinearNorm
        return bn[: -len("bn")] + "c", True
    raise KeyError(f"no fold rule for BatchNorm {bn!r}")


def _resnet12_rule(bn: str) -> Optional[Tuple[str, bool]]:
    rule = _stem_rule(bn, bn.split(".")[0])
    if rule:
        return rule
    raise KeyError(f"no fold rule for BatchNorm {bn!r}")


def _fold(state_dict: Mapping[str, torch.Tensor], rule: FoldRule) -> Dict[str, torch.Tensor]:
    """State dict of an unfolded encoder -> state dict of the same
    architecture built with ``fold_bn=True`` (CPU float32 tensors)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    out = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    for bn in [k[: -len(".running_var")] for k in sd if k.endswith(".running_var")]:
        found = rule(bn)
        if found is None:
            continue
        conv, after = found
        scale, bias, mean, var = (sd[f"{bn}.{n}"].astype(np.float64) for n in _BN_LEAVES)
        m = scale / np.sqrt(var + BN_EPS)
        t = bias - mean * m
        w = sd[f"{conv}.weight"].astype(np.float64)
        b = sd.get(f"{conv}.bias", np.zeros(w.shape[0])).astype(np.float64)
        if after:
            w, b = w * m.reshape((-1,) + (1,) * (w.ndim - 1)), b * m + t
        else:
            w, b = w * m[None, :, None, None], b + w[:, :, 0, 0] @ t
        out[f"{conv}.weight"] = torch.from_numpy(w.astype(np.float32))
        out[f"{conv}.bias"] = torch.from_numpy(b.astype(np.float32))
        for n in _BN_LEAVES:
            del out[f"{bn}.{n}"]
    return out


def fold_visformer(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return _fold(state_dict, _visformer_rule)


def fold_levit(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return _fold(state_dict, _levit_rule)


def fold_resnet12(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return _fold(state_dict, _resnet12_rule)


_FOLDERS = {"Visformer": fold_visformer, "Levit": fold_levit, "ResNet12": fold_resnet12}


def fold_encoder_in_head(head):
    """A copy of ``head`` (e.g. MetaBaseline) whose encoder is rebuilt with
    ``fold_bn=True`` and folded weights; the head's own parameters (``temp``)
    are carried over. Raises for a family without a folder, as JAX does."""
    enc = head.encoder
    folder = _FOLDERS.get(type(enc).__name__)
    if folder is None:
        raise NotImplementedError(
            f"no BN folder for encoder {type(enc).__name__}; supported: {sorted(_FOLDERS)}")
    new_head = head.clone(encoder=enc.clone(fold_bn=True))
    sd = {f"encoder.{k}": v for k, v in folder(enc.state_dict()).items()}
    sd.update({k: v for k, v in head.state_dict().items() if not k.startswith("encoder.")})
    new_head.load_state_dict(sd)
    return new_head
