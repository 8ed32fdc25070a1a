"""The BERT encoder of HF ``BertModel`` (bge-large-en), plain float32:
word + position + token-type embeddings and LayerNorm, then per layer
self-attention (scores scaled by 1/sqrt(head_dim), padded keys masked
with the float32 minimum), output dense, residual LayerNorm, dense with
exact erf GELU, dense, residual LayerNorm.  The sentence vector is the
CLS state (or the masked mean), L2-normalised."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def layer_norm(x, state, name, eps):
    return F.layer_norm(x, x.shape[-1:], state[f"{name}.weight"],
                        state[f"{name}.bias"], eps)


def linear(x, state, name):
    return F.linear(x, state[f"{name}.weight"], state[f"{name}.bias"])


def encode(state: dict, cfg: dict, ids: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """ids/mask [b, s] -> hidden [b, s, h], ``state`` float32."""
    b, s = ids.shape
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, eps = h // heads, cfg["layer_norm_eps"]
    pos = torch.arange(s, device=ids.device)
    x = (state["embeddings.word_embeddings.weight"][ids]
         + state["embeddings.position_embeddings.weight"][pos][None]
         + state["embeddings.token_type_embeddings.weight"][0])
    x = layer_norm(x, state, "embeddings.LayerNorm", eps)
    bias = (1.0 - mask[:, None, None, :].float()) * torch.finfo(
        torch.float32).min
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}"

        def heads_of(t):
            return t.view(b, s, heads, hd).transpose(1, 2)

        q = heads_of(linear(x, state, f"{p}.attention.self.query"))
        k = heads_of(linear(x, state, f"{p}.attention.self.key"))
        v = heads_of(linear(x, state, f"{p}.attention.self.value"))
        scores = q @ k.transpose(-1, -2) / math.sqrt(hd) + bias
        ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2)
        attn = linear(ctx.reshape(b, s, h), state,
                      f"{p}.attention.output.dense")
        x = layer_norm(attn + x, state, f"{p}.attention.output.LayerNorm",
                       eps)
        inter = F.gelu(linear(x, state, f"{p}.intermediate.dense"))
        x = layer_norm(linear(inter, state, f"{p}.output.dense") + x, state,
                       f"{p}.output.LayerNorm", eps)
    return x


def sentence_vectors(state: dict, cfg: dict, ids, mask) -> torch.Tensor:
    hidden = encode(state, cfg, ids, mask)
    if cfg.get("pooling", "cls") == "mean":
        m = mask[:, :, None].float()
        pooled = (hidden * m).sum(1) / m.sum(1).clamp(min=1.0)
    else:
        pooled = hidden[:, 0]
    return F.normalize(pooled, dim=-1)
