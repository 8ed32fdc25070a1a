"""BERT encoder (BGE class) in PyTorch.

Counterpart of ``llm_weighted_consensus_tpu/models/bert.py``:

* ``BertEncoder`` is an ``nn.Module`` tree named as HuggingFace's
  ``BertModel`` (``embeddings.word_embeddings``, ``encoder.layer.{i}.
  attention.self.query``, ...), so an HF state dict loads as it is: torch
  ``Linear`` keeps ``[out, in]`` and no transpose is needed;
* ``encode``, ``pool`` and ``embed`` are plain functions over it, with the
  reference's numerics: matmuls in the param dtype with f32
  accumulation, LayerNorm, GELU, softmax and pooling in f32, padding as
  a -1e9 additive key bias (never -inf);
* attention goes through ``ops.attention.attention``: the CUDA kernel for
  tensors on the card, its plain version on the CPU.  No other path
  exists on the card;
* the dense layers go through ``layers.dense_cfg`` / ``mlp_cfg``: a layer
  stack quantized by ``models.quant`` (``QuantLinear``) runs the W8A8 or
  W4A8 kernel for every dense layer, with the GELU in the MLP expansion's
  epilogue, and never reaches ``F.linear``.

The layer loop is a Python loop over ``encoder.layer``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.attention import attention
from . import quant
from .configs import BertConfig, position_base
from .layers import dense_cfg, layer_norm, mlp_cfg


class LayerNorm(nn.Module):
    """HF-named LayerNorm parameters applied with the one-pass
    ``layers.layer_norm``."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h
        )
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h)
        self.LayerNorm = LayerNorm(h, config.layer_norm_eps)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)


class BertDenseNorm(nn.Module):
    """A dense layer followed by the residual LayerNorm (HF's
    ``BertSelfOutput`` and ``BertOutput``)."""

    def __init__(self, in_dim: int, config: BertConfig):
        super().__init__()
        self.dense = nn.Linear(in_dim, config.hidden_size)
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps)


class BertAttention(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(config)
        self.output = BertDenseNorm(config.hidden_size, config)


class BertIntermediate(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.attention = BertAttention(config)
        self.intermediate = BertIntermediate(config)
        self.output = BertDenseNorm(config.intermediate_size, config)


class BertLayerStack(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            BertLayer(config) for _ in range(config.num_layers)
        )


class BertEncoder(nn.Module):
    """Embeddings, the layer stack and the embedding LayerNorm, under
    HF ``BertModel`` parameter names (no pooler)."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.encoder = BertLayerStack(config)

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        return encode(self, input_ids, attention_mask, token_type_ids)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _attention(x, p: BertAttention, key_bias, config: BertConfig):
    b, s, h = x.shape
    nh, hd = config.num_heads, config.head_dim
    sa = p.self
    q = dense_cfg(x, sa.query).view(b, s, nh, hd)
    k = dense_cfg(x, sa.key).view(b, s, nh, hd)
    v = dense_cfg(x, sa.value).view(b, s, nh, hd)
    ctx = attention(q, k, v, key_bias, 1.0 / float(hd) ** 0.5)
    return dense_cfg(ctx.reshape(b, s, h), p.output.dense)


def _layer(x, layer: BertLayer, key_bias, config: BertConfig):
    attn = _attention(x, layer.attention, key_bias, config)
    x = layer.attention.output.LayerNorm(x + attn)
    mlp = mlp_cfg(x, layer.intermediate.dense, layer.output.dense)
    return layer.output.LayerNorm(x + mlp)


def encode(
    model: BertEncoder,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """input_ids[b, s], attention_mask[b, s] -> hidden[b, s, h] in the
    param dtype.  Positions are left-aligned from ``position_base``."""
    config = model.config
    b, s = input_ids.shape
    base = position_base(config)
    if base + s > config.max_position_embeddings:
        # an index past the table would fail (or, on the card, read out
        # of bounds) — refuse it by name
        raise ValueError(
            f"sequence {s} (position base {base}) exceeds "
            f"max_position_embeddings={config.max_position_embeddings}"
        )
    emb = model.embeddings
    ids = input_ids.long()
    x = emb.word_embeddings.weight[ids]
    positions = torch.arange(base, base + s, device=ids.device)
    x = x + emb.position_embeddings.weight[positions][None]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(ids)
    x = x + emb.token_type_embeddings.weight[token_type_ids.long()]
    x = emb.LayerNorm(x)
    key_bias = torch.where(
        attention_mask > 0,
        torch.zeros((), dtype=torch.float32, device=ids.device),
        torch.full((), -1e9, dtype=torch.float32, device=ids.device),
    )
    for layer in model.encoder.layer:
        x = _layer(x, layer, key_bias, config)
    return x


def pool(
    hidden: torch.Tensor,
    attention_mask: torch.Tensor,
    pooling: str = "cls",
    normalize: bool = True,
) -> torch.Tensor:
    """hidden[b, s, h] -> embedding[b, h] f32: CLS or masked mean, then
    L2 normalisation, all in f32."""
    if pooling == "cls":
        emb = hidden[:, 0, :].float()
    elif pooling == "mean":
        mask = attention_mask[:, :, None].float()
        emb = torch.sum(hidden.float() * mask, dim=1) / torch.clamp(
            torch.sum(mask, dim=1), min=1.0
        )
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    if normalize:
        norm = torch.sqrt(torch.sum(emb * emb, dim=-1, keepdim=True))
        emb = emb / torch.clamp(norm, min=1e-12)
    return emb


def embed(
    model: BertEncoder,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    pooling: str = "cls",
    normalize: bool = True,
) -> torch.Tensor:
    """ids -> pooled vectors [b, h] f32."""
    hidden = encode(model, input_ids, attention_mask)
    return pool(hidden, attention_mask, pooling, normalize)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller asks for the CPU.  Asking for CUDA without a
    card raises; nothing falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return device


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _build(
    state: dict, config: BertConfig, dtype: Optional[torch.dtype], device
) -> BertEncoder:
    """A BertEncoder on ``device`` (CUDA unless ``"cpu"``) in ``dtype``
    (by default bf16 on CUDA, f32 on the CPU) whose every parameter is
    filled from ``state`` ({HF name: array}), gradients off.  Dense layers
    that ``state`` carries quantized (``<name>.weight_q``, ``.scale``,
    ``.bias``) become ``quant.QuantLinear`` modules with those bytes."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    with torch.device("meta"):
        model = BertEncoder(config)
    model = model.to_empty(device=device).to(dtype)
    quant.load_quantized(model, state, device)
    names = {name for name, _ in model.named_parameters()}
    missing = sorted(names - set(state))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors: {missing[:4]}")
    with torch.no_grad():
        for name, param in model.named_parameters():
            value = torch.tensor(np.asarray(state[name]))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"{name}: checkpoint shape {tuple(value.shape)} != "
                    f"{tuple(param.shape)}"
                )
            param.copy_(value.to(device=device, dtype=dtype))
    return model.requires_grad_(False).eval()


def init_params(
    config: BertConfig,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> BertEncoder:
    """Random init from ``numpy.random.default_rng(seed)``: N(0, 0.02)
    embeddings and dense weights, zero biases, unit LayerNorm scales.
    On CUDA unless ``device="cpu"``."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {
            name: tuple(p.shape)
            for name, p in BertEncoder(config).named_parameters()
        }
    state = {}
    for name, shape in shapes.items():
        if name.endswith("LayerNorm.weight"):
            state[name] = np.ones(shape, np.float32)
        elif name.endswith("bias"):
            state[name] = np.zeros(shape, np.float32)
        else:
            state[name] = rng.standard_normal(shape, dtype=np.float32) * 0.02
    return _build(state, config, dtype, device)


def from_hf_state_dict(
    state_dict: dict,
    config: BertConfig,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> BertEncoder:
    """An HF BERT state dict ({name: array}, any ``bert.`` prefix already
    stripped) -> BertEncoder, on CUDA unless ``device="cpu"``.  The
    pooler and buffers such as ``embeddings.position_ids`` are
    ignored."""
    return _build(state_dict, config, dtype, device)
