"""Flax variables -> the port's state dict: weights carried across from the
JAX package.

The inverse of ``fewshot_vit_tpu/checkpoint/torch_convert.py::convert_by_rule``:
a flax tree of numpy arrays (``{"params", "batch_stats"}``, unfolded or
folded) becomes a state dict whose keys are the reference torch model's, the
output of the encoder family's key rule (copies of the JAX package's rules:
``visformer_key``, ``resnet_key``, ``resnet12_drop_key``, ``convnet4_key``,
``deit_key``, ``nest_key``, ``swin_key``, ``levit_key``, ``lvvit_key``). The
port's modules are laid out under those names, so the same keys load
reference ``.pth`` files. Layouts:

  * conv kernel HWIO (kh, kw, I/g, O) -> OIHW (O, I/g, kh, kw);
  * Dense kernel (I, O) -> ``(O, I)`` for an ``nn.Linear``-shaped target and
    ``(O, I, 1, 1)`` for a 1x1-conv target (Visformer's);
  * a 4-D positional embedding is transposed NHWC -> NCHW only when the
    target's shape differs (Visformer's 2-D maps); NesT's token-major
    (1, T, N, C) embeddings already match;
  * JAX's int8 tree (``models/quant.py``): each int8 ``kernel`` takes the
    layouts above with its dtype kept, and ``wscale``, ``bias`` and the 0-d
    ``ascale`` keep their names beside ``weight``, the buffers of the port's
    ``QuantConv`` / ``QuantDense``.

The target is the module (or state dict) passed as ``like``; without one the
layout falls back to Visformer's (Dense -> 1x1 conv, except a head's ``fc``
and ``linear``). A head's ``encoder`` subtree maps under ``encoder.`` through
its family's rule; the head's own entries map at the top level under the
same names, the port's modules being named as the flax subtrees: the
MetaBaseline and meta-token ``temp`` (0-d), the DeepEMD pretrain ``fc``, the
classifiers (``classifier.linear`` ...), ``intra_task_learner.fc1`` /
``intra_class_learner.fc2`` (``token-label-ep-rw``), ``projection_0/2/4``
and ``classifier_local_0/2/4`` (``token-label-v2``) and ``transformer.q``
/ ``.k`` / ``.v`` (``meta-token-v3``).

The mapping is a relabelling with transpositions, so it is linear: applied to
a tree of JAX GRADIENTS (``{"params": grads}``) it gives the port's gradients
under the parameters' names, which is how the tests compare ``jax.grad`` with
``.grad``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}

FlaxKeyFn = Callable[..., str]


_DOWNSAMPLE = {"downsample_conv": ["downsample", "0"], "downsample_bn": ["downsample", "1"]}


def _parts(p: str, stage: str = "") -> list:
    """One flax path element -> torch key parts: ``stage2_0`` -> [stage2, 0]
    for the family's ``stage`` prefix, a downsample pair -> its Sequential
    index, anything else unchanged."""
    if stage and p.startswith(stage) and "_" in p:
        return p.split("_")
    return _DOWNSAMPLE.get(p, [p])


def visformer_key(path: Tuple[str, ...], prefix: str = "") -> str:
    """Visformer family.

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
        torch_parts += _parts(p, "stage")
    if leaf in _BN_LEAF and (parts[-1].startswith("bn") or parts[-1].startswith("downsample_bn")):
        leaf = _BN_LEAF[leaf]
    elif leaf == "kernel":
        leaf = "weight"
    return prefix + ".".join(torch_parts + [leaf])


def resnet_key(path: Tuple[str, ...], prefix: str = "") -> str:
    """ResNet-18/50: ``layer2_1/conv1`` -> ``layer2.1.conv1``; ResNet-12:
    ``layer1/conv1`` -> ``layer1.conv1``; downsample pairs -> Sequential
    indices."""
    parts = list(path)
    leaf = parts.pop()
    torch_parts = []
    for p in parts:
        torch_parts += _parts(p, "layer")
    if leaf in _BN_LEAF and (parts[-1].startswith("bn") or parts[-1].startswith("downsample_bn")):
        leaf = _BN_LEAF[leaf]
    elif leaf == "kernel":
        leaf = "weight"
    return prefix + ".".join(torch_parts + [leaf])


def resnet12_drop_key(path: Tuple[str, ...], prefix: str = "") -> str:
    """resnet12-drop: blocks in single-element Sequentials, ``layer1/conv1``
    -> ``layer1.0.conv1``; the block's ``num_batches_tracked`` maps through."""
    parts = list(path)
    leaf = parts.pop()
    torch_parts = []
    for p in parts:
        torch_parts += [p, "0"] if p.startswith("layer") else _parts(p)
    if leaf in _BN_LEAF and parts and (parts[-1].startswith("bn")
                                       or parts[-1].startswith("downsample_bn")):
        leaf = _BN_LEAF[leaf]
    elif leaf == "kernel":
        leaf = "weight"
    return prefix + ".".join(torch_parts + [leaf])


def convnet4_key(path: Tuple[str, ...], prefix: str = "") -> str:
    """ConvNet4: ``conv{i}`` / ``bn{i}`` -> ``encoder.{i}.0`` / ``.1``."""
    name, leaf = path[0], path[-1]
    i = name[-1]
    if name.startswith("conv"):
        return f"{prefix}encoder.{i}.0.{'weight' if leaf == 'kernel' else leaf}"
    return f"{prefix}encoder.{i}.1.{_BN_LEAF.get(leaf, leaf)}"


def _ln_or_bn_leaf(leaf: str, parts) -> str:
    """BN statistics and ``bn*`` / ``downsample_bn`` affines as BatchNorm
    names; LayerNorm ``scale`` and Dense/conv ``kernel`` as ``weight``."""
    if leaf in ("mean", "var") or (
            leaf in ("scale", "bias") and parts
            and (parts[-1].startswith("bn") or parts[-1] == "downsample_bn")):
        return _BN_LEAF[leaf]
    return {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)


def deit_key(path: Tuple[str, ...], prefix: str = "") -> str:
    """DeiT: ``blocks_3/attn/qkv`` -> ``blocks.3.attn.qkv``; ``mlp_fc1`` ->
    ``mlp.fc1``; ``patch_embed`` -> ``patch_embed.proj``."""
    parts = list(path)
    leaf = parts.pop()
    if not parts and leaf in ("cls_token", "pos_embed"):
        return prefix + leaf
    torch_parts = []
    for p in parts:
        if p.startswith("blocks_"):
            torch_parts += ["blocks", p.split("_")[1]]
        elif p == "patch_embed":
            torch_parts += ["patch_embed", "proj"]
        elif p.startswith("mlp_fc"):
            torch_parts += ["mlp", p.split("_")[1]]
        else:
            torch_parts.append(p)
    leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    return prefix + ".".join(torch_parts + [leaf])


def lvvit_key(path: Tuple[str, ...], prefix: str = "") -> str:
    """LV-ViT: as ``deit_key``, but the conv-stem children of ``patch_embed``
    pass through (``patch_embed.conv1``, ``.proj``), BN leaves renamed."""
    parts = list(path)
    leaf = parts.pop()
    if not parts and leaf in ("cls_token", "pos_embed"):
        return prefix + leaf
    torch_parts = []
    for p in parts:
        if p.startswith("blocks_"):
            torch_parts += ["blocks", p.split("_")[1]]
        elif p.startswith("mlp_fc"):
            torch_parts += ["mlp", p.split("_")[1]]
        else:
            torch_parts += _parts(p)
    return prefix + ".".join(torch_parts + [_ln_or_bn_leaf(leaf, parts)])


def nest_key(path: Tuple[str, ...], prefix: str = "") -> str:
    """NesT: ``levels_1_layers_0/attn/qkv`` ->
    ``levels.1.transformer_encoder.0.attn.qkv``; ``levels_0_pos_embed`` ->
    ``levels.0.pos_embed``; ``levels_1_pool/conv`` -> ``levels.1.pool.conv``;
    the plain patch conv -> ``patch_embed.proj``; resembed stem children as
    Visformer's."""
    parts = list(path)
    leaf = parts.pop()
    if not parts and leaf.startswith("levels_") and leaf.endswith("pos_embed"):
        return f"{prefix}levels.{leaf.split('_')[1]}.pos_embed"
    torch_parts = []
    for p in parts:
        if p.startswith("levels_") and "_layers_" in p:
            _, i, _, j = p.split("_")
            torch_parts += ["levels", i, "transformer_encoder", j]
        elif p.startswith("levels_") and p.endswith("_pool"):
            torch_parts += ["levels", p.split("_")[1], "pool"]
        elif p.startswith("mlp_fc"):
            torch_parts += ["mlp", p.split("_")[1]]
        else:
            torch_parts += _parts(p)
    if torch_parts == ["patch_embed"]:  # the plain patch conv
        torch_parts = ["patch_embed", "proj"]
    return prefix + ".".join(torch_parts + [_ln_or_bn_leaf(leaf, parts)])


def swin_key(path: Tuple[str, ...], prefix: str = "") -> str:
    """Swin: ``layers_0_blocks_1/attn/qkv`` -> ``layers.0.blocks.1.attn.qkv``;
    ``layers_0_downsample/reduction`` -> ``layers.0.downsample.reduction``;
    ``patch_embed_proj`` / ``patch_embed_norm`` -> ``patch_embed.proj`` /
    ``.norm``; 3-conv stem children as Visformer's."""
    parts = list(path)
    leaf = parts.pop()
    if not parts and leaf == "absolute_pos_embed":
        return prefix + leaf
    torch_parts = []
    for p in parts:
        if p.startswith("layers_") and "_blocks_" in p:
            _, i, _, j = p.split("_")
            torch_parts += ["layers", i, "blocks", j]
        elif p.startswith("layers_") and p.endswith("_downsample"):
            torch_parts += ["layers", p.split("_")[1], "downsample"]
        elif p in ("patch_embed_proj", "patch_embed_norm"):
            torch_parts += ["patch_embed", p.split("_")[2]]
        elif p.startswith("mlp_fc"):
            torch_parts += ["mlp", p.split("_")[1]]
        else:
            torch_parts += _parts(p)
    return prefix + ".".join(torch_parts + [_ln_or_bn_leaf(leaf, parts)])


def levit_key(path: Tuple[str, ...], prefix: str = "") -> str:
    """LeViT: Residual-wrapped blocks under ``.m``; MLP LinearNorms at
    Sequential indices 0 / 2; the subsample's q and every proj at index 1.

      blocks_0/qkv/c/kernel     -> blocks.0.m.qkv.c.weight
      blocks_0/proj/c/kernel    -> blocks.0.m.proj.1.c.weight
      blocks_0/attention_biases -> blocks.0.m.attention_biases
      blocks_1/fc1/bn/scale     -> blocks.1.m.0.bn.weight
      blocks_2_sub/kv/c/kernel  -> blocks.2.kv.c.weight
      blocks_2_sub/q/c/kernel   -> blocks.2.q.1.c.weight
    """
    parts = list(path)
    leaf = parts.pop()
    is_sub = bool(parts) and parts[0].endswith("_sub")
    named = {"fc1": ["0"], "fc2": ["2"], "proj": ["proj", "1"], "q": ["q", "1"], **_DOWNSAMPLE}
    torch_parts = []
    for p in parts:
        if p.startswith("blocks_"):
            i = p.split("_")[1]
            torch_parts += ["blocks", i] if is_sub else ["blocks", i, "m"]
        else:
            torch_parts += named.get(p, [p])
    if leaf in _BN_LEAF and parts and (parts[-1] == "bn" or parts[-1].startswith("bn")
                                       or parts[-1] == "downsample_bn"):
        leaf = _BN_LEAF[leaf]
    elif leaf == "kernel":
        leaf = "weight"
    return prefix + ".".join(torch_parts + [leaf])


_VISFORMER = ("visformer_micro_80", "visformer_tiny_80", "visformer_small", "net5_80")
_NEST = ("nest_nano_80", "nest_micro_80", "nest_micro_resembed_80", "nest_micro_resembed_2x_80",
         "nest_12m_v3", "nest_micro_v2_gpsa", "nest_micro_v2_rel_80",
         "nest_micro_resembed_ada_80")
_SWIN = ("swin_nano_patch4_window5_80", "swin_micro_resembed_80",
         "swin_micro_v2_resembed_ada_80")
_DEIT = ("deit_tiny_patch16_224", "deit_small_patch16_224", "deit_base_patch16_224",
         "deit_nano_patch16_224", "deit_nano_patch6_84", "deit_micro_patch6_84")

# encoder registry name -> flax key rule (the JAX package's ENCODER_KEY_FNS)
ENCODER_KEY_FNS: Dict[str, FlaxKeyFn] = {
    **{n: visformer_key for n in _VISFORMER},
    **{n: resnet_key for n in ("resnet12", "resnet12-wide", "resnet18", "resnet50")},
    "resnet12-drop": resnet12_drop_key,
    "convnet4": convnet4_key,
    **{n: nest_key for n in _NEST},
    **{n: swin_key for n in _SWIN},
    "levit_micro_80": levit_key,
    "lvvit_micro_80": lvvit_key,
    **{n: deit_key for n in _DEIT},
}

# encoder class name -> flax key rule
CLASS_KEY_FNS: Dict[str, FlaxKeyFn] = {
    "Visformer": visformer_key, "ResNet": resnet_key, "ResNet12": resnet_key,
    "ResNet12Drop": resnet12_drop_key, "ConvNet4": convnet4_key, "Nest": nest_key,
    "SwinTransformer": swin_key, "Levit": levit_key, "LVViT": lvvit_key,
    "VisionTransformer": deit_key,
}


def key_fn_of(encoder: Union[None, str, nn.Module]) -> FlaxKeyFn:
    """The flax key rule of an encoder given by registry name, by module (its
    class) or by nothing (Visformer's)."""
    if encoder is None:
        return visformer_key
    if isinstance(encoder, str):
        table, name = ENCODER_KEY_FNS, encoder
    else:
        table, name = CLASS_KEY_FNS, type(encoder).__name__
    if name not in table:
        raise KeyError(f"no flax key rule for encoder {name!r}; known: {sorted(table)}")
    return table[name]


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(path: Tuple[str, ...], w: np.ndarray,
                     target: Optional[Tuple[int, ...]]) -> np.ndarray:
    name = path[-1]
    if name == "kernel":
        if w.ndim == 4:
            return np.transpose(w, (3, 2, 0, 1))
        if w.ndim != 2:
            raise ValueError(f"kernel of rank {w.ndim} at {'/'.join(path)}")
        linear = (len(target) == 2 if target is not None
                  else path[-2] in ("fc", "linear"))  # Visformer's: a head's nn.Linear
        return np.transpose(w, (1, 0)) if linear else np.transpose(w, (1, 0))[:, :, None, None]
    if name.startswith("pos_embed") and w.ndim == 4 and (target is None
                                                          or tuple(w.shape) != tuple(target)):
        return np.transpose(w, (0, 3, 1, 2))
    return w


def from_flax(variables: Mapping[str, Any], like: Union[None, nn.Module,
              Mapping[str, torch.Tensor]] = None,
              encoder: Union[None, str, nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy leaves) -> state dict. ``like`` (a module or its
    state dict) decides the layouts; the key rule is ``encoder``'s (a registry
    name or a module), else that of ``like``'s encoder (``like.encoder`` for
    a head), else Visformer's. Raises if two leaves map to one key."""
    if encoder is None and isinstance(like, nn.Module):
        encoder = like if type(like).__name__ in CLASS_KEY_FNS else getattr(like, "encoder", None)
        if type(encoder).__name__ not in CLASS_KEY_FNS:
            encoder = None
    key_fn = key_fn_of(encoder)
    shapes = None
    if like is not None:
        sd = like.state_dict() if isinstance(like, nn.Module) else like
        shapes = {k: tuple(v.shape) for k, v in sd.items()}
    is_head = any("encoder" in tree for tree in variables.values())
    out: Dict[str, torch.Tensor] = {}
    for col, tree in variables.items():
        for path, leaf in _flatten(tree):
            if path[0] == "encoder":
                key = key_fn(path[1:], prefix="encoder.")
            else:  # a head's own entries (temp, fc, classifier.*) or a bare encoder's
                key = visformer_key(path) if is_head else key_fn(path)
            if key in out:
                raise ValueError(f"flax leaf {col}/{'/'.join(path)} maps to {key!r} twice")
            target = None if shapes is None else shapes.get(key)
            w = _to_torch_layout(path, np.asarray(leaf), target)
            # ascontiguousarray makes a 0-d leaf (temp) 1-d: keep its shape
            out[key] = torch.from_numpy(np.ascontiguousarray(w).reshape(w.shape))
    return out


def load_flax(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load flax variables into ``module`` (an encoder, or a head around
    one: its class picks the key rule); every flax leaf must fill exactly
    one of its state-dict entries and every entry must be filled, or this
    raises (``strict`` loading, shapes checked)."""
    module.load_state_dict(from_flax(variables, like=module), strict=True)
    return module
