"""Reference ``.pth`` checkpoints -> the port's modules (counterpart:
``fewshot_vit_tpu/checkpoint/io.py`` ``load_torch_state_dict`` ..
``load_reference_encoder_checkpoint`` and ``convert_by_rule`` of
``checkpoint/torch_convert.py``).

The reference saves ``{"model", "model_args", "model_sd"}`` dicts (SUN-D:
``{"params": state_dict}`` with ``module.`` prefixes). The port's state-dict
keys already follow the reference's names for every encoder family (the
outputs of ``from_flax``'s key rules), so ingestion is a relabelling under
the contract of the JAX package's ``convert_by_rule``:

  * every entry of the port module's state dict is filled from the key its
    rule names, or this raises ``KeyError``;
  * a 2-D ``(O, I)`` torch weight fills a port 1x1 conv ``(O, I, 1, 1)`` and
    a ``(O, I, 1, 1)`` one fills a port ``nn.Linear``; any other rank
    change raises;
  * shapes are checked;
  * every torch tensor is consumed once, except the non-learned buffers
    (``num_batches_tracked``, ``relative_position_index``, ``attn_mask``,
    ``attention_bias_idxs``, which the port holds as non-persistent buffers
    or not at all); any other leftover raises "unconsumed torch tensors".
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from .from_flax import ENCODER_KEY_FNS as _FLAX_KEY_FNS

# non-learned buffers, plus 'adapool.weight', a dead reference parameter
# (the JAX package's convert_by_rule skips the same suffixes)
_BUFFERS = ("num_batches_tracked", "relative_position_index", "attn_mask",
            "attention_bias_idxs", "adapool.weight")

KeyFn = Callable[..., str]


def _strip_module(key: str) -> str:
    return key[len("module."):] if key.startswith("module.") else key


def load_torch_state_dict(path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Read a reference checkpoint file -> (flat state dict of CPU tensors,
    meta). Reads the ``model_sd`` layout and SUN-D's ``params`` layout (or a
    bare state dict), strips ``module.``, keeps the 0-d ``temp``. Loaded with
    ``weights_only=True``: a reference file holds tensors, dicts and plain
    values only."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and ("model_sd" in blob or "params" in blob):
        sd = blob.get("model_sd", blob.get("params"))
        meta = {k: blob[k] for k in ("model", "model_args") if k in blob}
    else:
        sd, meta = blob, {}
    return {_strip_module(k): v.detach() for k, v in sd.items()}, meta


def strip_prefix(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """Select the keys under ``prefix`` (``module.`` tolerated) and strip it."""
    out = {}
    for k, v in sd.items():
        k = _strip_module(k)
        if k.startswith(prefix):
            out[k[len(prefix):]] = v
    return out


def same_key(key: str, prefix: str = "") -> str:
    """Port key -> reference key: the same name, since the port's modules are
    laid out as the reference's."""
    return prefix + key


# encoder registry name -> torch key rule, for every encoder the JAX
# package's table names
ENCODER_KEY_FNS: Dict[str, KeyFn] = {name: same_key for name in _FLAX_KEY_FNS}


def encoder_key_fn_for(encoder_name: str) -> KeyFn:
    """The torch key rule of a registered encoder name; raises ``KeyError``
    by name for any other."""
    try:
        return ENCODER_KEY_FNS[encoder_name]
    except KeyError:
        raise KeyError(f"no torch key rule for encoder {encoder_name!r}; known: "
                       f"{sorted(ENCODER_KEY_FNS)}") from None


def head_key_fn(encoder_key_fn: Optional[KeyFn] = None) -> KeyFn:
    """Torch-key rule of a head-wrapped model: encoder entries through the
    encoder's rule under ``encoder.``; ``temp``, ``fc`` and the classifiers
    (``classifier.linear`` ...) under their own names."""
    enc_fn = encoder_key_fn or same_key

    def key_fn(key: str) -> str:
        if key.startswith("encoder."):
            return enc_fn(key[len("encoder."):], prefix="encoder.")
        return key

    return key_fn


def convert_by_rule(target: Mapping[str, torch.Tensor], torch_sd: Mapping[str, torch.Tensor],
                    key_fn: KeyFn) -> Dict[str, torch.Tensor]:
    """Fill the state dict ``target`` (a port module's) from ``torch_sd``;
    ``key_fn(port key) -> torch key``. Raises on a missing key, a rank or
    shape mismatch, or an unconsumed torch tensor."""
    used, out = set(), {}
    for key, leaf in target.items():
        tkey = key_fn(key)
        if tkey not in torch_sd:
            raise KeyError(f"torch key {tkey!r} (for {key!r}) not in state dict")
        w = torch_sd[tkey]
        used.add(tkey)
        if w.dim() != leaf.dim():
            if w.dim() == 2 and leaf.dim() == 4 and leaf.shape[2:] == (1, 1):
                w = w[:, :, None, None]  # Linear (O, I) -> 1x1 conv
            elif w.dim() == 4 and leaf.dim() == 2 and w.shape[2:] == (1, 1):
                w = w[:, :, 0, 0]  # 1x1 conv -> Linear
            else:
                raise ValueError(f"rank mismatch at {key}: torch {tuple(w.shape)} -> "
                                 f"port {tuple(leaf.shape)}")
        if w.shape != leaf.shape:
            raise ValueError(f"shape mismatch at {key}: torch {tuple(w.shape)} vs "
                             f"port {tuple(leaf.shape)}")
        out[key] = w.to(leaf.dtype).contiguous()
    leftover = sorted(k for k in torch_sd if k not in used and not k.endswith(_BUFFERS))
    if leftover:
        raise ValueError(f"unconsumed torch tensors: {leftover[:10]} "
                         f"(+{max(0, len(leftover) - 10)} more)")
    return out


def load_reference_head_checkpoint(path: str, module: nn.Module,
                                   encoder_key_fn: Optional[KeyFn] = None) -> nn.Module:
    """Fill a head (MetaBaseline, DeepEMD, Classifier ..., built to match the
    file) from a reference ``.pth``; returns ``module``."""
    sd, _ = load_torch_state_dict(path)
    module.load_state_dict(convert_by_rule(module.state_dict(), sd, head_key_fn(encoder_key_fn)),
                           strict=True)
    return module


def load_reference_encoder_checkpoint(path: str, encoder: nn.Module,
                                      encoder_key_fn: Optional[KeyFn] = None) -> nn.Module:
    """Fill ``encoder`` from the ``encoder.*`` entries of a reference
    ``.pth``, or from the whole dict when nothing is nested under
    ``encoder.`` (a bare-encoder file); head entries (``temp``,
    ``classifier.*``, ``fc``) are ignored, as the reference's
    ``load_encoder`` keeps ``.encoder`` of the saved model. Returns
    ``encoder``."""
    sd, _ = load_torch_state_dict(path)
    enc_sd = strip_prefix(sd, "encoder.") or sd
    encoder.load_state_dict(
        convert_by_rule(encoder.state_dict(), enc_sd, encoder_key_fn or same_key),
        strict=True)
    return encoder
