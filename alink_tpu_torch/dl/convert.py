"""Carry weights between the reference's flax parameter tree and the port's
``TransformerEncoder`` state dict.

Layout rules (flax leaf → torch parameter):

- a module path ``layer_<i>/...`` becomes ``layers.<i>....``; every other
  module keeps its name (``attention/qkv`` → ``attention.qkv``);
- ``DenseGeneral((3, h*d))`` kernel ``(hidden, 3, h*d)`` → ``qkv.weight``
  ``(3·h·d, hidden)``: rows ``[0, h·d)`` are q, then k, then v; its bias
  ``(3, h*d)`` flattens in the same order;
- every ``Dense``/``DenseGeneral`` kernel ``(in, out)`` → the transposed
  ``Linear.weight`` ``(out, in)``; its ``bias`` is copied;
- every ``Embed`` ``embedding`` → that embedding's ``weight``;
- every ``LayerNorm`` ``scale``/``bias`` → that norm's ``weight``/``bias``.

Values are copied exactly; dtypes are kept (fp32 for the reference's
parameters, int8 for a quantized tree). :func:`keras_flax_to_torch` and
:func:`keras_torch_to_flax` carry the KerasSequential variables, and the
ResNet variables under the names :func:`resnet_flax_to_torch` and
:func:`resnet_torch_to_flax` (``params`` and ``batch_stats``: HWIO kernels
→ OIHW weights, ``conv_proj``/``norm_proj`` and the zero-initialised last
scale included); :func:`to_flax` and :func:`from_flax` pick the pair for a
model.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..common.exceptions import AkIllegalDataException


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_name(path) -> str:
    parts = []
    for p in path:
        if p.startswith("layer_") and p[len("layer_"):].isdigit():
            parts += ["layers", p[len("layer_"):]]
        else:
            parts.append(p)
    return ".".join(parts)


def flax_to_torch(params) -> Dict[str, torch.Tensor]:
    """State dict for :class:`~alink_tpu_torch.dl.modules.TransformerEncoder`
    from the reference's parameter tree of numpy arrays (with or without the
    top-level ``"params"`` collection)."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        mod, name = _module_name(path[:-1]), path[-1]
        if name == "kernel":
            if arr.ndim == 3:       # DenseGeneral((3, h*d)): (in, 3, h*d)
                arr = arr.reshape(arr.shape[0], -1)
            elif arr.ndim != 2:
                raise AkIllegalDataException(
                    f"unexpected kernel shape {arr.shape} at {'/'.join(path)}")
            out[f"{mod}.weight"] = torch.from_numpy(arr.T.copy())
        elif name == "bias":
            out[f"{mod}.bias"] = torch.from_numpy(arr.reshape(-1).copy())
        elif name in ("embedding", "scale"):
            out[f"{mod}.weight"] = torch.from_numpy(arr.copy())
        else:
            raise AkIllegalDataException(
                f"unknown flax parameter {'/'.join(path)}")
    return out


def torch_to_flax(state_dict, cfg) -> dict:
    """The inverse of :func:`flax_to_torch`: ``{"params": tree}`` of numpy
    arrays, shaped as the reference's flax ``TransformerEncoder`` for
    ``cfg`` (a :class:`~alink_tpu_torch.dl.modules.BertConfig`)."""
    tree: dict = {}
    hd = cfg.hidden_size
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        parts = key.split(".")
        if parts[0] == "layers":
            parts = [f"layer_{parts[1]}"] + parts[2:]
        *mods, name = parts
        is_qkv = mods[-1] == "qkv"
        is_norm = mods[-1].startswith("ln_")
        if mods[-1].endswith("_emb") and not is_norm:
            leaf, value = "embedding", arr
        elif name == "weight" and is_norm:
            leaf, value = "scale", arr
        elif name == "weight":
            leaf, value = "kernel", arr.T
            if is_qkv:
                value = value.reshape(hd, 3, hd)
        else:
            leaf, value = "bias", arr.reshape(3, hd) if is_qkv else arr
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(value)
    return {"params": tree}


# ---------------------------------------------------------------------------
# KerasSequential and ResNet
# ---------------------------------------------------------------------------


def keras_flax_to_torch(variables) -> Dict[str, torch.Tensor]:
    """State dict for :class:`~alink_tpu_torch.dl.modules.KerasSequential`
    or :class:`~alink_tpu_torch.dl.resnet.ResNet` from the reference's
    variables ``{"params", and with a BatchNorm "batch_stats"}`` of numpy
    arrays. Module names are flax's; a 2-D ``kernel`` (in, out) becomes the
    transposed ``weight``, a conv's (*window, in, out) the ``weight`` (out,
    in, *window); ``scale`` becomes ``weight``; the running ``mean``/``var``
    keep their names. Any array dtype is carried as it is (int8
    included)."""
    out: Dict[str, torch.Tensor] = {}
    for coll, tree in variables.items():
        if coll not in ("params", "batch_stats"):
            raise AkIllegalDataException(f"unknown flax collection {coll!r}")
        for path, leaf in _flatten(tree):
            arr = np.asarray(leaf)
            mod, name = ".".join(path[:-1]), path[-1]
            if name == "kernel":
                if arr.ndim < 2:
                    raise AkIllegalDataException(
                        f"unexpected kernel shape {arr.shape} at "
                        f"{'/'.join(path)}")
                arr = arr.transpose((arr.ndim - 1, arr.ndim - 2)
                                    + tuple(range(arr.ndim - 2)))
                name = "weight"
            elif name == "scale":
                name = "weight"
            elif name not in ("bias", "mean", "var"):
                raise AkIllegalDataException(
                    f"unknown flax parameter {'/'.join(path)}")
            out[f"{mod}.{name}"] = torch.from_numpy(arr.copy())
    return out


def keras_torch_to_flax(state_dict) -> dict:
    """The inverse of :func:`keras_flax_to_torch`: the reference's variables,
    with ``batch_stats`` only when the model has a BatchNorm."""
    out: dict = {"params": {}}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        *mods, name = key.split(".")
        coll = "params"
        if name in ("mean", "var"):
            coll = "batch_stats"
        elif name == "weight":
            if arr.ndim >= 2:
                name, arr = "kernel", arr.transpose(
                    tuple(range(2, arr.ndim)) + (1, 0))
            else:
                name = "scale"
        node = out.setdefault(coll, {})
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return out


# ResNet's variables follow the same rules (its conv kernels are 4-D)
resnet_flax_to_torch = keras_flax_to_torch
resnet_torch_to_flax = keras_torch_to_flax


# ---------------------------------------------------------------------------
# any model
# ---------------------------------------------------------------------------


def to_flax(model) -> dict:
    """The reference's variables tree of ``model``'s state (BERT,
    KerasSequential or ResNet), as numpy arrays."""
    from .modules import KerasSequential
    from .resnet import ResNet

    if isinstance(model, (KerasSequential, ResNet)):
        return keras_torch_to_flax(model.state_dict())
    return torch_to_flax(model.state_dict(), model.cfg)


def from_flax(model, variables) -> Dict[str, torch.Tensor]:
    """``model``'s state dict from the reference's variables tree."""
    from .modules import KerasSequential
    from .resnet import ResNet

    if isinstance(model, (KerasSequential, ResNet)):
        return keras_flax_to_torch(variables)
    return flax_to_torch(variables)
