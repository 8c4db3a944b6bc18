"""Pretrained BERT checkpoint ingest (port of ``alink_tpu/dl/pretrained.py``).

A checkpoint directory is resolved from ``checkpointFilePath`` or from
``bertModelName`` under the local plugin directory, as in the reference, and
read into the reference's flax parameter layout (qkv fused), which
:func:`~alink_tpu_torch.dl.convert.flax_to_torch` carries into the port's
encoder. Formats, auto-detected:

- HuggingFace layout: ``config.json`` + ``model.safetensors`` (read by the
  standalone reader below), ``pytorch_model.bin`` (``torch.load``) or
  ``flax_model.msgpack`` (:mod:`~alink_tpu_torch.common.flax_msgpack`), and
  ``vocab.txt``;
- a google-research TF v1 checkpoint is recognised and refused with a clear
  error: reading it needs TensorFlow, which the port does not carry.

:func:`save_bert_checkpoint` writes the HF layout back, so a model trained by
either package is re-ingested by both.
"""

from __future__ import annotations

import json
import os
import struct
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..common import flax_msgpack
from ..common.exceptions import (AkIllegalArgumentException,
                                 AkPluginNotExistException,
                                 AkUnsupportedOperationException)

# normalized model names accepted by ``bertModelName`` -> plugin subdirectory
MODEL_NAME_DIRS = {
    "base-uncased": "bert-base-uncased",
    "base-cased": "bert-base-cased",
    "base-chinese": "bert-base-chinese",
    "base-multilingual-cased": "bert-base-multilingual-cased",
}


def _normalize_model_name(name: str) -> str:
    n = name.strip().lower().replace("_", "-")
    if n.startswith("bert-"):
        n = n[len("bert-"):]
    return n


def resolve_bert_resource(model_name: str) -> str:
    """``bertModelName`` as a local checkpoint directory under the plugin
    dir, or raise naming exactly what to place where."""
    from ..common.env import plugin_dir

    n = _normalize_model_name(model_name)
    sub = MODEL_NAME_DIRS.get(n, f"bert-{n}")
    root = plugin_dir()
    cand = os.path.join(root, "bert", sub)
    if os.path.isdir(cand) and _detect_format(cand) is not None:
        return cand
    raise AkPluginNotExistException(
        f"pretrained BERT resource {model_name!r} not found: place a "
        f"checkpoint directory at {cand} (HuggingFace layout with "
        f"config.json + model.safetensors + vocab.txt). There is no "
        f"downloader: the files must be staged locally.")


def _detect_format(path: str) -> Optional[str]:
    if os.path.isfile(os.path.join(path, "model.safetensors")):
        return "safetensors"
    if os.path.isfile(os.path.join(path, "pytorch_model.bin")):
        return "torch"
    if os.path.isfile(os.path.join(path, "flax_model.msgpack")):
        return "flax"
    for f in os.listdir(path) if os.path.isdir(path) else []:
        if f.endswith(".ckpt.index") or f.endswith(".ckpt.meta"):
            return "tf_ckpt"
    return None


# ---------------------------------------------------------------------------
# raw tensor readers -> flat {hf_style_name: np.ndarray}
# ---------------------------------------------------------------------------


def _read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Standalone safetensors reader: an 8-byte little-endian header length,
    a JSON header, then raw little-endian tensor buffers."""
    dtypes = {
        "F64": np.float64, "F32": np.float32, "F16": np.float16,
        "BF16": None, "I64": np.int64, "I32": np.int32, "I16": np.int16,
        "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
    }
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        blob = f.read()
    for name, info in header.items():
        if name == "__metadata__":
            continue
        a, b = info["data_offsets"]
        raw = blob[a:b]
        if info["dtype"] == "BF16":
            u16 = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = u16.view(np.float32)
        else:
            arr = np.frombuffer(raw, dtypes[info["dtype"]])
        out[name] = arr.reshape(info["shape"]).copy()
    return out


def _read_torch_bin(path: str) -> Dict[str, np.ndarray]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in state.items()}


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _read_flax_msgpack(path: str) -> Dict[str, np.ndarray]:
    """HF flax names (``embeddings.word_embeddings.embedding``, ...) renamed
    to the torch-style names :func:`bert_tree_from_hf` reads; the renames
    are anchored to the last path segment."""
    with open(path, "rb") as f:
        tree = flax_msgpack.loads(f.read())
    out = {}
    for k, v in _flatten(tree):
        if k.endswith(".embedding"):
            k = k[: -len(".embedding")] + ".weight"
        elif k.endswith(".kernel"):  # flax kernels are already (in, out)
            k = k[: -len(".kernel")] + ".weight_t"
        elif k.endswith(".scale"):
            k = k[: -len(".scale")] + ".weight"
        out[k] = np.asarray(v)
    return out


def _read_tf_ckpt_dir(path: str) -> Dict[str, np.ndarray]:
    raise AkUnsupportedOperationException(
        f"{path} holds a TensorFlow v1 checkpoint (bert_model.ckpt.*): "
        f"reading it needs TensorFlow, which alink_tpu_torch does not use. "
        f"Convert it to the HuggingFace layout (config.json + "
        f"model.safetensors + vocab.txt) first.")


def _infer_do_lower_case(path: str, hf_cfg: Dict[str, Any]) -> bool:
    """HF keeps the casing flag in tokenizer_config.json; else the config;
    else the directory name ('-cased' checkpoints are not lowercased)."""
    tc = os.path.join(path, "tokenizer_config.json")
    if os.path.isfile(tc):
        with open(tc) as f:
            v = json.load(f).get("do_lower_case")
        if v is not None:
            return bool(v)
    if "do_lower_case" in hf_cfg:
        return bool(hf_cfg["do_lower_case"])
    base = os.path.basename(os.path.normpath(path)).lower()
    if "uncased" in base:
        return True
    if "cased" in base or "chinese" in base or "multilingual" in base:
        return False
    return True


def _load_config(path: str) -> Dict[str, Any]:
    for fname in ("config.json", "bert_config.json"):
        p = os.path.join(path, fname)
        if os.path.isfile(p):
            with open(p) as f:
                return json.load(f)
    raise AkIllegalArgumentException(
        f"no config.json / bert_config.json under {path}")


def load_vocab_file(path: str) -> "list[str]":
    p = os.path.join(path, "vocab.txt") if os.path.isdir(path) else path
    if not os.path.isfile(p):
        raise AkPluginNotExistException(
            f"vocab.txt not found under {os.path.dirname(p) or p}: the "
            f"pretrained tokenizer needs the checkpoint's WordPiece vocab")
    with open(p, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]


# ---------------------------------------------------------------------------
# HF-name tensors -> the encoder's parameter tree (flax layout)
# ---------------------------------------------------------------------------


class _W:
    """Name-indexed tensor store with (in, out)-orientation handling."""

    def __init__(self, raw: Dict[str, np.ndarray]):
        self.raw = {k[len("bert."):] if k.startswith("bert.") else k: v
                    for k, v in raw.items()}

    def dense(self, prefix: str) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (kernel (in, out), bias)."""
        if prefix + ".weight_t" in self.raw:  # already (in, out)
            k = self.raw[prefix + ".weight_t"]
        else:
            k = self.raw[prefix + ".weight"].T  # torch (out, in)
        b = self.raw[prefix + ".bias"]
        return np.ascontiguousarray(k, np.float32), b.astype(np.float32)

    def ln(self, prefix: str) -> Dict[str, np.ndarray]:
        return {"scale": self.raw[prefix + ".weight"].astype(np.float32),
                "bias": self.raw[prefix + ".bias"].astype(np.float32)}

    def emb(self, name: str) -> np.ndarray:
        return self.raw[name + ".weight"].astype(np.float32)

    def has(self, name: str) -> bool:
        return any(k.startswith(name) for k in self.raw)


def bert_tree_from_hf(raw: Dict[str, np.ndarray],
                      num_layers: int) -> Dict[str, Any]:
    """The encoder subtree (no head) from HF-style named tensors, in the
    reference's layout: qkv fused as kernel (hidden, 3, hidden) and bias
    (3, hidden)."""
    w = _W(raw)
    tree: Dict[str, Any] = {
        "tok_emb": {"embedding": w.emb("embeddings.word_embeddings")},
        "pos_emb": {"embedding": w.emb("embeddings.position_embeddings")},
        "ln_emb": w.ln("embeddings.LayerNorm"),
    }
    if w.has("embeddings.token_type_embeddings"):
        tree["type_emb"] = {
            "embedding": w.emb("embeddings.token_type_embeddings")}
    hidden = tree["tok_emb"]["embedding"].shape[1]
    for i in range(num_layers):
        p = f"encoder.layer.{i}."
        qk, qb = w.dense(p + "attention.self.query")
        kk, kb = w.dense(p + "attention.self.key")
        vk, vb = w.dense(p + "attention.self.value")
        ok, ob = w.dense(p + "attention.output.dense")
        ik, ib = w.dense(p + "intermediate.dense")
        mk, mb = w.dense(p + "output.dense")
        qkv = np.stack([qk, kk, vk], axis=1)      # (hidden, 3, hidden)
        if qkv.shape[0] != hidden:
            raise AkIllegalArgumentException(
                f"layer {i}: qkv kernel {qkv.shape} does not match hidden "
                f"size {hidden}")
        tree[f"layer_{i}"] = {
            "attention": {
                "qkv": {"kernel": qkv,
                        "bias": np.stack([qb, kb, vb], axis=0)},
                "out": {"kernel": ok, "bias": ob},
            },
            "ln_att": w.ln(p + "attention.output.LayerNorm"),
            "mlp_in": {"kernel": ik, "bias": ib},
            "mlp_out": {"kernel": mk, "bias": mb},
            "ln_mlp": w.ln(p + "output.LayerNorm"),
        }
    if w.has("pooler.dense"):
        pk, pb = w.dense("pooler.dense")
        tree["pooler"] = {"kernel": pk, "bias": pb}
    return tree


def load_bert_checkpoint(path: str):
    """A checkpoint directory as ``(config_dict, encoder_subtree)``:
    ``config_dict`` has the architecture under :class:`BertConfig` field
    names plus ``do_lower_case``; the subtree is in the reference's layout."""
    fmt = _detect_format(path)
    if fmt is None:
        raise AkPluginNotExistException(
            f"no BERT checkpoint found under {path} (looked for "
            f"model.safetensors / pytorch_model.bin / flax_model.msgpack / "
            f"*.ckpt.index)")
    hf_cfg = _load_config(path)
    cfg = {
        "vocab_size": hf_cfg["vocab_size"],
        "hidden_size": hf_cfg["hidden_size"],
        "num_layers": hf_cfg.get("num_hidden_layers", hf_cfg.get("num_layers")),
        "num_heads": hf_cfg.get("num_attention_heads", hf_cfg.get("num_heads")),
        "intermediate_size": hf_cfg["intermediate_size"],
        "max_position": hf_cfg.get("max_position_embeddings", 512),
        "type_vocab_size": hf_cfg.get("type_vocab_size", 2),
        "do_lower_case": _infer_do_lower_case(path, hf_cfg),
    }
    reader = {
        "safetensors": lambda p: _read_safetensors(
            os.path.join(p, "model.safetensors")),
        "torch": lambda p: _read_torch_bin(os.path.join(p, "pytorch_model.bin")),
        "flax": lambda p: _read_flax_msgpack(
            os.path.join(p, "flax_model.msgpack")),
        "tf_ckpt": _read_tf_ckpt_dir,
    }[fmt]
    tree = bert_tree_from_hf(reader(path), cfg["num_layers"])
    return cfg, tree


def init_from_pretrained(model, cfg, subtree: Dict[str, Any],
                         seed: int = 0) -> Dict[str, Any]:
    """A fresh init of ``model`` (:meth:`TransformerEncoder.init_weights`
    from ``seed``) with the checkpoint's encoder subtree grafted in, as the
    reference's ``{"params": tree}``: the head (and any part the checkpoint
    lacks) keeps its fresh init. Checkpoint tensors the model has no place
    for are reported in a warning. (The reference's ``sample`` batch is not
    needed: the port's modules know their shapes.)"""
    from .convert import torch_to_flax

    model.init_weights(seed)
    template = torch_to_flax(model.state_dict(), cfg)["params"]
    skipped: list = []
    merged = _merge(template, subtree, skipped=skipped)
    if skipped:
        warnings.warn(
            f"pretrained checkpoint tensors not consumed by the model "
            f"(left at fresh init): {skipped[:8]}"
            f"{' ...' if len(skipped) > 8 else ''}")
    return {"params": merged}


def _merge(template: Dict[str, Any], new: Dict[str, Any], *, skipped: list,
           prefix: str = "") -> Dict[str, Any]:
    out = dict(template)
    for k, v in new.items():
        if k not in out:
            skipped.append(prefix + k)
            continue
        if isinstance(v, dict) and isinstance(out[k], dict):
            out[k] = _merge(out[k], v, skipped=skipped, prefix=prefix + k + ".")
        else:
            tv = out[k]
            if tuple(np.shape(tv)) != tuple(np.shape(v)):
                raise AkIllegalArgumentException(
                    f"pretrained tensor {k} has shape {np.shape(v)}, model "
                    f"expects {tuple(np.shape(tv))}: config mismatch")
            out[k] = np.asarray(v, np.float32)
    return out


# ---------------------------------------------------------------------------
# export: params -> HF-layout directory
# ---------------------------------------------------------------------------


def save_bert_checkpoint(params, cfg, path: str, vocab: "list[str]") -> None:
    """Writes an HF-layout checkpoint (config.json + model.safetensors +
    vocab.txt) from the encoder's parameters: the reference's tree, or a
    port state dict (carried over by
    :func:`~alink_tpu_torch.dl.convert.torch_to_flax`)."""
    if params and all(isinstance(v, torch.Tensor) for v in params.values()):
        from .convert import torch_to_flax

        params = torch_to_flax(params, cfg)
    os.makedirs(path, exist_ok=True)
    p = params.get("params", params)
    tensors: Dict[str, np.ndarray] = {}

    def dense_out(prefix: str, sub):  # to torch (out, in)
        tensors[prefix + ".weight"] = np.ascontiguousarray(
            np.asarray(sub["kernel"], np.float32).T)
        tensors[prefix + ".bias"] = np.asarray(sub["bias"], np.float32)

    def ln_out(prefix: str, sub):
        tensors[prefix + ".weight"] = np.asarray(sub["scale"], np.float32)
        tensors[prefix + ".bias"] = np.asarray(sub["bias"], np.float32)

    tensors["bert.embeddings.word_embeddings.weight"] = np.asarray(
        p["tok_emb"]["embedding"], np.float32)
    tensors["bert.embeddings.position_embeddings.weight"] = np.asarray(
        p["pos_emb"]["embedding"], np.float32)
    if "type_emb" in p:
        tensors["bert.embeddings.token_type_embeddings.weight"] = np.asarray(
            p["type_emb"]["embedding"], np.float32)
    ln_out("bert.embeddings.LayerNorm", p["ln_emb"])
    n_layers = cfg.num_layers if hasattr(cfg, "num_layers") else cfg["num_layers"]
    for i in range(n_layers):
        lp = p[f"layer_{i}"]
        hfp = f"bert.encoder.layer.{i}."
        qkv_k = np.asarray(lp["attention"]["qkv"]["kernel"], np.float32)
        qkv_b = np.asarray(lp["attention"]["qkv"]["bias"], np.float32)
        for j, nm in enumerate(("query", "key", "value")):
            tensors[hfp + f"attention.self.{nm}.weight"] = (
                np.ascontiguousarray(qkv_k[:, j, :].T))
            tensors[hfp + f"attention.self.{nm}.bias"] = qkv_b[j]
        dense_out(hfp + "attention.output.dense", lp["attention"]["out"])
        ln_out(hfp + "attention.output.LayerNorm", lp["ln_att"])
        dense_out(hfp + "intermediate.dense", lp["mlp_in"])
        dense_out(hfp + "output.dense", lp["mlp_out"])
        ln_out(hfp + "output.LayerNorm", lp["ln_mlp"])
    if "pooler" in p:
        dense_out("bert.pooler.dense", p["pooler"])

    _write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    c = cfg if isinstance(cfg, dict) else {
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position": cfg.max_position,
        "type_vocab_size": cfg.type_vocab_size,
    }
    hf_cfg = {
        "model_type": "bert",
        "vocab_size": c["vocab_size"],
        "hidden_size": c["hidden_size"],
        "num_hidden_layers": c["num_layers"],
        "num_attention_heads": c["num_heads"],
        "intermediate_size": c["intermediate_size"],
        "max_position_embeddings": c["max_position"],
        "type_vocab_size": c.get("type_vocab_size", 2),
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=1)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")


def _write_safetensors(path: str, tensors: Dict[str, np.ndarray]) -> None:
    dtypes = {np.dtype(np.float32): "F32", np.dtype(np.float64): "F64",
              np.dtype(np.int64): "I64", np.dtype(np.int32): "I32"}
    header: Dict[str, Any] = {}
    off = 0
    bufs = []
    for name in sorted(tensors):
        a = np.ascontiguousarray(tensors[name])
        raw = a.tobytes()
        header[name] = {"dtype": dtypes[a.dtype], "shape": list(a.shape),
                        "data_offsets": [off, off + len(raw)]}
        off += len(raw)
        bufs.append(raw)
    hb = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for b in bufs:
            f.write(b)
