"""Frozen-BN folding over the port's weights (counterpart:
``fewshot_vit_tpu/models/fold.py``).

In eval mode every BatchNorm is the fixed per-channel affine
y = x * m + t, m = weight / sqrt(running_var + eps), t = bias - running_mean * m,
which folds exactly into an adjacent conv (same float64 math as the JAX
package, cast to float32):

  * BN after a conv (the stem and the patch embeds): scale the OUT axis,
    weight' = weight * m[:, None, None, None], bias' = bias * m + t;
  * BN before a 1x1 conv (the block pre-norms feeding ``attn.qkv`` and
    ``mlp.conv1``): scale the IN axis, weight' = weight * m[None, :, None, None],
    bias' = bias + weight[:, :, 0, 0] @ t.

The final ``norm`` has no adjacent conv and stays.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .common import BN_EPS
from .visformer import Visformer

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _fold_rule(bn: str) -> Optional[Tuple[str, bool]]:
    """(conv prefix, BN-after-conv?) for the BN at key prefix ``bn``; None
    for the final norm, which stays."""
    if bn == "norm.bn":
        return None
    if bn == "stem.downsample.1":
        return "stem.downsample.0", True
    m = re.fullmatch(r"stem\.bn(\d)", bn)
    if m:
        return f"stem.conv{m[1]}", True
    m = re.fullmatch(r"(patch_embed\d)\.norm\.bn", bn)
    if m:
        return f"{m[1]}.proj", True
    m = re.fullmatch(r"(stage\d\.\d+)\.norm1\.bn", bn)
    if m:
        return f"{m[1]}.attn.qkv", False
    m = re.fullmatch(r"(stage\d\.\d+)\.norm2\.bn", bn)
    if m:
        return f"{m[1]}.mlp.conv1", False
    raise KeyError(f"no fold rule for BatchNorm {bn!r}")


def fold_visformer(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """State dict of an unfolded Visformer -> state dict of the same
    architecture built with ``fold_bn=True`` (CPU float32 tensors)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    out = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    for bn in [k[: -len(".running_var")] for k in sd if k.endswith(".running_var")]:
        rule = _fold_rule(bn)
        if rule is None:
            continue
        conv, after = rule
        scale, bias, mean, var = (sd[f"{bn}.{n}"].astype(np.float64) for n in _BN_LEAVES)
        m = scale / np.sqrt(var + BN_EPS)
        t = bias - mean * m
        w = sd[f"{conv}.weight"].astype(np.float64)
        b = sd.get(f"{conv}.bias", np.zeros(w.shape[0])).astype(np.float64)
        if after:
            w, b = w * m[:, None, None, None], b * m + t
        else:
            w, b = w * m[None, :, None, None], b + w[:, :, 0, 0] @ t
        out[f"{conv}.weight"] = torch.from_numpy(w.astype(np.float32))
        out[f"{conv}.bias"] = torch.from_numpy(b.astype(np.float32))
        for n in _BN_LEAVES:
            del out[f"{bn}.{n}"]
    return out


def fold_encoder_in_head(head):
    """A copy of ``head`` (e.g. MetaBaseline) whose Visformer encoder is
    rebuilt with ``fold_bn=True`` and folded weights; the head's own
    parameters (``temp``) are carried over."""
    enc = head.encoder
    if not isinstance(enc, Visformer):
        raise NotImplementedError(
            f"no BN folder for encoder {type(enc).__name__}; supported: Visformer")
    new_head = head.clone(encoder=enc.clone(fold_bn=True))
    sd = {f"encoder.{k}": v for k, v in fold_visformer(enc.state_dict()).items()}
    sd.update({k: v for k, v in head.state_dict().items() if not k.startswith("encoder.")})
    new_head.load_state_dict(sd)
    return new_head
