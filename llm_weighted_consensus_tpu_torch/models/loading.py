"""Offline encoder weight loading (local files only, no network).

Counterpart of ``llm_weighted_consensus_tpu/models/loading.py`` and of
the reward model's ``load_rm_params`` (``models/reranker.py`` there).
Two accepted layouts:

* an HF snapshot directory (``model.safetensors`` or ``pytorch_model.bin``
  and usually ``vocab.txt``);
* a single weights file (``.safetensors`` / ``.bin`` / ``.pt``).

``.safetensors`` files are read by the small numpy parser below (an
8-byte little-endian header length, a JSON header, then the raw
buffers), so no ``safetensors`` package is needed; ``.bin``/``.pt`` load
with ``torch.load(weights_only=True)``.  HF state dicts may carry a
``bert.`` (or, for the reward model, ``deberta.``) prefix from task-head
checkpoints; it is stripped.  The port reads HF weights and its own
checkpoint files (``train.save_checkpoint``); an Orbax checkpoint
directory of the JAX trainer is refused by name: carry its parameters
over with ``models.convert`` and ``train.save_checkpoint``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional

import numpy as np
import torch

from .configs import BertConfig, DebertaConfig
from .spm import SPM_FILES

_HF_FILES = ("model.safetensors", "pytorch_model.bin")

_ST_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


def read_safetensors(path: str) -> dict:
    """``.safetensors`` file -> {name: np.ndarray}.  BF16 tensors are
    widened to float32 (numpy has no bfloat16)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = data[begin:end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif info["dtype"] in _ST_DTYPES:
            arr = np.frombuffer(
                raw, dtype=np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
            )
        else:
            raise ValueError(
                f"{path}: tensor {name!r} has unsupported dtype "
                f"{info['dtype']}"
            )
        out[name] = arr.reshape(shape).copy()
    return out


def _strip_prefix(state: dict) -> dict:
    if any(key.startswith("bert.") for key in state):
        return {
            (key[len("bert."):] if key.startswith("bert.") else key): value
            for key, value in state.items()
        }
    return state


def load_state_dict(path: str) -> dict:
    """Weights file -> {name: np.ndarray}, ``bert.`` prefix stripped."""
    if path.endswith(".safetensors"):
        state = read_safetensors(path)
    else:
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        state = {k: v.float().numpy() if v.dtype == torch.bfloat16
                 else v.numpy() for k, v in loaded.items()}
    return _strip_prefix(state)


def _is_orbax_dir(path: str) -> bool:
    entries = set(os.listdir(path))
    return bool(
        entries
        & {"_METADATA", "manifest.ocdbt", "_CHECKPOINT_METADATA", "d"}
    )


def _weights_file(path: str) -> str:
    if os.path.isdir(path):
        for name in _HF_FILES:
            candidate = os.path.join(path, name)
            if os.path.exists(candidate):
                return candidate
        if _is_orbax_dir(path):
            raise NotImplementedError(
                f"{path!r} is an Orbax checkpoint of the JAX trainer, which "
                "the port does not read: it reads HF weights and its own "
                "checkpoint files; carry the parameters over with "
                "models.convert and train.save_checkpoint"
            )
        raise FileNotFoundError(
            f"{path!r} is a directory but contains no HF weights file "
            f"({'/'.join(_HF_FILES)})"
        )
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def load_params(
    path: str,
    config: BertConfig,
    dtype: Optional[torch.dtype] = None,
    device=None,
):
    """A ``bert.BertEncoder`` holding the checkpoint at ``path`` (see
    module doc), on CUDA unless ``device="cpu"``, in ``dtype`` (by
    default bf16 on CUDA, f32 on the CPU)."""
    from . import bert

    state = load_state_dict(_weights_file(path))
    return bert.from_hf_state_dict(state, config, dtype=dtype, device=device)


def find_vocab(weights_path: str) -> Optional[str]:
    """Tokenizer asset sitting next to the weights, if any (HF snapshot
    layout): WordPiece ``vocab.txt`` or a SentencePiece model proto
    (``spm.SPM_FILES``: XLM-R's ``sentencepiece.bpe.model``, DeBERTa's
    ``spm.model``, T5-style ``spiece.model``)."""
    root = (
        weights_path
        if os.path.isdir(weights_path)
        else os.path.dirname(weights_path)
    )
    for name in ("vocab.txt",) + SPM_FILES:
        candidate = os.path.join(root, name)
        if os.path.exists(candidate):
            return candidate
    return None


def _strip_deberta_prefix(state: dict) -> dict:
    """HF task-model checkpoints prefix the backbone with ``deberta.``;
    the head weights (``pooler``, ``classifier``) stay unprefixed."""
    return {
        (key[len("deberta."):] if key.startswith("deberta.") else key): value
        for key, value in state.items()
    }


def load_rm_params(
    path: str,
    config: DebertaConfig,
    dtype: Optional[torch.dtype] = None,
    device=None,
):
    """The reward model from a local HF DeBERTa-v2/v3 snapshot directory or
    weights file -> ``(deberta.DebertaModel, head_loaded)``, on CUDA
    unless ``device="cpu"``.  ``head_loaded`` is False for an
    encoder-only checkpoint, whose reward head is random-init (and so
    synthetic state, gated like random weights)."""
    from . import deberta

    state = _strip_deberta_prefix(load_state_dict(_weights_file(path)))
    model = deberta.from_hf_weights(state, config, dtype=dtype, device=device)
    return model, "pooler.dense.weight" in state


def load_hf_config(path: str) -> BertConfig:
    """``BertConfig`` from an HF snapshot's ``config.json`` (``path`` is
    the directory or the file)."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    with open(path, encoding="utf-8") as f:
        cfg = json.load(f)
    return BertConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg.get("type_vocab_size", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        pad_token_id=cfg.get("pad_token_id", 0),
    )
