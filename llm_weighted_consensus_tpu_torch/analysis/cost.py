"""FLOPs and bytes of one serving dispatch, counted from the encoder's
config and the bucket's shape: the port's source of the figures in
``roofline.json`` (the reference takes them from XLA's
``cost_analysis``; torch has no such call).

Per bucket label (``models/embedder.py``'s device-timing labels):

* ``embed(b=B,s=S)`` — the encoder forward over B padded rows of S
  tokens, CLS or mean pooling and the L2 normalisation;
* ``vote1(n=N,s=S)`` — the forward over N rows, then the cosine vote of
  one request (``ops.kernels.cosine_vote``);
* ``many(r=R,n=N,s=S)`` — the forward over R x N rows, then R votes;
* ``packed(b=B,l=L,k=K)`` — the packed forward over B rows of L tokens
  (attention counted dense over each row: the segment kernel's skipped
  tiles depend on the data, not on the bucket), then B x K pooled slots.

``flops`` counts the dense products (q, k, v, the attention output and
the two MLP layers: ``2 x tokens x in x out`` each), the attention's
QK^T and PV (``2 x rows x S^2 x H`` each), the element-wise passes
(bias adds, residual adds, LayerNorms, the GELU, the softmax, the
embedding sums) at ``ELEMENTWISE`` operations per element, and the vote
(the Gram matrix, ``2 x N^2 x H`` per request, and its softmax).
``bytes_accessed`` counts the weights read once (the word-embedding rows
the batch gathers, not the whole table), the hidden state read and
written once per layer, the ids and mask in and the pooled vectors (or
the confidences) out.  ``product_flops`` is the dense and attention part
alone: what ``torch.utils.flop_counter.FlopCounterMode`` counts over the
plain forward.
"""

from __future__ import annotations

import re
from typing import Dict

# operations per element of each element-wise pass (the forms of
# models/layers.py): a LayerNorm (square, two means, subtract, rsqrt,
# scale, shift), the bf16 A&S GELU, the softmax (scale, bias, max,
# exp, sum, divide)
ELEMENTWISE = {"layer_norm": 8, "gelu": 20, "softmax": 6, "add": 1}

_LABEL = re.compile(r"^(?P<kind>\w+)\((?P<args>[^)]*)\)$")


def parse_label(label: str) -> tuple:
    """``"many(r=8,n=64,s=128)"`` -> ``("many", {"r": 8, "n": 64, "s":
    128})``; a mesh suffix (``@dp1xtp1``) must be split off first
    (``roofline.split_label``)."""
    m = _LABEL.match(label)
    if m is None:
        raise ValueError(f"not a bucket label: {label!r}")
    args = {}
    for part in m.group("args").split(","):
        key, _, value = part.partition("=")
        args[key.strip()] = int(value)
    return m.group("kind"), args


def encoder_cost(config, rows: int, s: int, dtype_bytes: int = 2) -> dict:
    """The forward over ``rows`` padded rows of ``s`` tokens ->
    ``{"product_flops", "flops", "bytes_accessed"}`` (module doc)."""
    h, inter, layers = (config.hidden_size, config.intermediate_size,
                        config.num_layers)
    tokens = rows * s
    dense = 2 * tokens * (4 * h * h + 2 * h * inter)
    attention = 4 * rows * s * s * h
    product = layers * (dense + attention)
    ew = ELEMENTWISE
    per_layer = (
        tokens * (4 * h + h + inter + h) * ew["add"]  # the six bias adds
        + 2 * tokens * h * ew["add"]  # the two residual adds
        + 2 * tokens * h * ew["layer_norm"]
        + tokens * inter * ew["gelu"]
        + rows * config.num_heads * s * s * ew["softmax"]
    )
    embeddings = tokens * h * (2 * ew["add"] + ew["layer_norm"])
    pooling = rows * h * 3  # the L2 norm's square, sum and divide
    flops = product + layers * per_layer + embeddings + pooling
    weights = layers * (
        4 * h * h + 2 * h * inter  # dense weights
        + 4 * h + inter + h  # dense biases
        + 4 * h  # two LayerNorms' scale and shift
    ) + 2 * h  # the embedding LayerNorm
    gathered = tokens * h + s * h + h  # word rows, positions, token type
    hidden = layers * 2 * tokens * h
    nbytes = ((weights + gathered + hidden) * dtype_bytes
              + tokens * 4 * 2)  # int32 ids and mask
    return {"product_flops": float(product), "flops": float(flops),
            "bytes_accessed": float(nbytes)}


def vote_cost(r: int, n: int, h: int) -> dict:
    """R cosine votes of N candidates of H f32 (the Gram matrix, the mean
    off-diagonal row sum, the masked softmax)."""
    flops = r * (2 * n * n * h + 3 * n * h + 8 * n)
    return {"flops": float(flops), "bytes_accessed": float(r * n * 4)}


def bucket_cost(config, label: str, dtype_bytes: int = 2) -> Dict[str, float]:
    """``{"flops", "bytes_accessed", "product_flops"}`` of one dispatch
    at the bucket ``label`` (module doc)."""
    kind, a = parse_label(label)
    h = config.hidden_size
    if kind == "embed":
        out = encoder_cost(config, a["b"], a["s"], dtype_bytes)
        out["bytes_accessed"] += a["b"] * h * 4
        return out
    if kind == "packed":
        out = encoder_cost(config, a["b"], a["l"], dtype_bytes)
        # positions and segment ids ride beside the ids; no mask
        out["bytes_accessed"] += a["b"] * a["l"] * 4 + a["b"] * a["k"] * (
            4 + h * 4)
        return out
    if kind == "vote1":
        r, n, s = 1, a["n"], a["s"]
    elif kind == "many":
        r, n, s = a["r"], a["n"], a["s"]
    else:
        raise ValueError(f"no cost model for bucket kind {kind!r}")
    out = encoder_cost(config, r * n, s, dtype_bytes)
    vote = vote_cost(r, n, h)
    out["flops"] += vote["flops"]
    out["bytes_accessed"] += vote["bytes_accessed"]
    return out
