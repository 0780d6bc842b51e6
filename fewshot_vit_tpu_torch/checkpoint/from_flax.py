"""Flax variables -> the port's state dict: weights carried across from the
JAX package.

The inverse of ``fewshot_vit_tpu/checkpoint/torch_convert.py::convert_by_rule``
for the Visformer family and heads around it: a flax tree of numpy arrays
(``{"params", "batch_stats"}``, unfolded or folded) becomes a state dict
whose keys follow ``visformer_key`` (the reference torch model's names), so
the same keys will load reference ``.pth`` files. Layouts:

  * conv kernel HWIO (kh, kw, I/g, O) -> OIHW (O, I/g, kh, kw);
  * Dense kernel (I, O) -> 1x1 conv (O, I, 1, 1);
  * 2-D positional embedding NHWC (1, H, W, C) -> NCHW (1, C, H, W).

A head's ``encoder`` subtree maps under the ``encoder.`` prefix; the
MetaBaseline ``temp`` and the DeepEMD pretrain ``fc`` map at the top level,
the classifiers under their names (``classifier.linear``,
``classifier_local.linear``, the ``nn-classifier``'s ``classifier.proto`` and
``classifier.temp``). ``fc`` and ``linear`` are plain ``nn.Linear``s: kernel
(I, O) -> weight (O, I). ``batch_stats`` of an
unfolded encoder become the ``running_mean`` / ``running_var`` buffers.

The mapping is a relabelling with transpositions, so it is linear: applied to
a tree of JAX GRADIENTS (``{"params": grads}``) it gives the port's gradients
under the parameters' names, which is how the tests compare ``jax.grad`` with
``.grad``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def visformer_key(path: Tuple[str, ...], prefix: str = "") -> str:
    """Flax path -> torch key for the Visformer family (a copy of the JAX
    package's rule).

      stem/conv1/kernel        -> stem.conv1.weight
      stem/downsample_bn/scale -> stem.downsample.1.weight
      stage2_0/attn/qkv/kernel -> stage2.0.attn.qkv.weight
      stage1_3/norm2/bn/scale  -> stage1.3.norm2.bn.weight
      norm/bn/mean             -> norm.bn.running_mean
      pos_embed1               -> pos_embed1
    """
    parts = list(path)
    leaf = parts.pop()
    if not parts and leaf.startswith("pos_embed"):
        return prefix + leaf
    torch_parts = []
    for p in parts:
        if p.startswith("stage") and "_" in p:
            s, i = p.split("_")
            torch_parts += [s, i]
        elif p == "downsample_conv":
            torch_parts += ["downsample", "0"]
        elif p == "downsample_bn":
            torch_parts += ["downsample", "1"]
        else:
            torch_parts.append(p)
    if leaf in _BN_LEAF and (parts[-1].startswith("bn") or parts[-1] == "bn"
                             or parts[-1].startswith("downsample_bn")):
        leaf = _BN_LEAF[leaf]
    elif leaf == "kernel":
        leaf = "weight"
    return prefix + ".".join(torch_parts + [leaf])


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(path: Tuple[str, ...], w: np.ndarray) -> np.ndarray:
    name = path[-1]
    if name == "kernel":
        if w.ndim == 2 and path[-2] in ("fc", "linear"):  # a head's nn.Linear
            return np.transpose(w, (1, 0))
        if w.ndim == 4:
            return np.transpose(w, (3, 2, 0, 1))
        if w.ndim == 2:
            return np.transpose(w, (1, 0))[:, :, None, None]
        raise ValueError(f"kernel of rank {w.ndim} at {'/'.join(path)}")
    if name.startswith("pos_embed") and w.ndim == 4:
        return np.transpose(w, (0, 3, 1, 2))
    return w


def from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy leaves) -> state dict. Raises if two leaves map
    to one key."""
    out: Dict[str, torch.Tensor] = {}
    for col, tree in variables.items():
        for path, leaf in _flatten(tree):
            if path[0] == "encoder":
                key = visformer_key(path[1:], prefix="encoder.")
            else:
                key = visformer_key(path)
            if key in out:
                raise ValueError(f"flax leaf {col}/{'/'.join(path)} maps to {key!r} twice")
            w = _to_torch_layout(path, np.asarray(leaf))
            out[key] = torch.from_numpy(np.ascontiguousarray(w))
    return out


def load_flax(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load flax variables into ``module``; every flax leaf must fill exactly
    one of its state-dict entries and every entry must be filled, or this
    raises (``strict`` loading, shapes checked)."""
    module.load_state_dict(from_flax(variables), strict=True)
    return module
