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
  tiles depend on the data, not on the bucket), then B x K pooled slots;
* ``ring(b=B,s=S)`` / ``ring_vote(n=N,s=S)`` — the ring's forward does
  the dense forward's work (its sp shards split it), so they count as
  ``embed`` / ``vote1``.

``shard_cost`` counts one shard's share of a mesh dispatch (the mesh
audit's budgets), ``deberta_cost`` the reward model's forward.

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


def encoder_cost(config, rows: int, s: int, dtype_bytes: int = 2,
                 tp: int = 1, sq: int = 0) -> dict:
    """The forward over ``rows`` padded rows of ``s`` tokens ->
    ``{"product_flops", "flops", "bytes_accessed"}`` (module doc).

    One shard's share (``shard_cost``): ``tp`` splits the dense layers,
    the attention heads, the column-split biases and the GELU (the
    row-split biases, residuals, LayerNorms and embeddings run whole on
    every tp shard, as the Megatron split has them); ``sq`` (default
    ``s``) is the query tokens per row a ring shard holds, its keys the
    whole sequence."""
    h, inter, layers = (config.hidden_size, config.intermediate_size,
                        config.num_layers)
    sq = sq or s
    tokens = rows * sq
    dense = 2 * tokens * (4 * h * h + 2 * h * inter) // tp
    attention = 4 * rows * sq * s * h // tp
    product = layers * (dense + attention)
    ew = ELEMENTWISE
    per_layer = (
        tokens * ((3 * h + inter) // tp + 2 * h) * ew["add"]  # six biases
        + 2 * tokens * h * ew["add"]  # the two residual adds
        + 2 * tokens * h * ew["layer_norm"]
        + tokens * (inter // tp) * ew["gelu"]
        + rows * (config.num_heads // tp) * sq * s * ew["softmax"]
    )
    embeddings = tokens * h * (2 * ew["add"] + ew["layer_norm"])
    pooling = rows * h * 3  # the L2 norm's square, sum and divide
    flops = product + layers * per_layer + embeddings + pooling
    weights = layers * (
        (4 * h * h + 2 * h * inter) // tp  # dense weights
        + (3 * h + inter) // tp + 2 * h  # dense biases
        + 4 * h  # two LayerNorms' scale and shift
    ) + 2 * h  # the embedding LayerNorm
    gathered = tokens * h + sq * h + h  # word rows, positions, token type
    hidden = layers * 2 * tokens * h
    nbytes = ((weights + gathered + hidden) * dtype_bytes
              + tokens * 4 * 2)  # int32 ids and mask
    return {"product_flops": float(product), "flops": float(flops),
            "bytes_accessed": float(nbytes)}


def deberta_cost(config, rows: int, s: int, dtype_bytes: int = 2,
                 tp: int = 1) -> dict:
    """The DeBERTa reward forward over ``rows`` rows of ``s`` tokens (one
    tp shard's share): the BERT-shaped encoder, plus per layer the
    disentangled terms (the position projections of the 2k-bucket table
    and the content-to-position and position-to-content scores, split
    over tp with the heads) and the reward head (its dense layer split
    over tp); no position table is gathered."""
    h, layers = config.hidden_size, config.num_layers
    out = encoder_cost(config, rows, s, dtype_bytes, tp=tp)
    buckets = 2 * config.att_span
    extra = layers * (2 * 2 * buckets * h * h // tp  # pos_q, pos_k
                      + 2 * 2 * rows * s * buckets * h // tp)  # c2p, p2c
    head = 2 * rows * h * h // tp + 2 * rows * h // tp
    out["product_flops"] += float(extra + head)
    out["flops"] += float(extra + head)
    out["bytes_accessed"] += float(
        (layers * 2 * buckets * h * h // tp + buckets * h + h * h // tp)
        * dtype_bytes)
    return out


def vote_cost(r: int, n: int, h: int) -> dict:
    """R cosine votes of N candidates of H f32 (the Gram matrix, the mean
    off-diagonal row sum, the masked softmax)."""
    flops = r * (2 * n * n * h + 3 * n * h + 8 * n)
    return {"flops": float(flops), "bytes_accessed": float(r * n * 4)}


def shard_cost(config, label: str, dp: int, tp: int, sp: int = 1,
               dtype_bytes: int = 4) -> Dict[str, float]:
    """``{"flops", "bytes_accessed"}`` of one shard of a dispatch at
    ``label`` over a dp x tp[ x sp] mesh (the mesh audit's JXA009/JXA010
    figures, ``analysis/budgets.json``): the rows split over dp, the
    encoder over tp (``encoder_cost``'s tp share); a ring shard
    (``ring``, ``ring_vote``) holds s/sp query tokens over whole weights
    (the ring's params are replicated); ``reward_packed`` is the DeBERTa
    packed forward, rows over dp and tp-split (``deberta_cost``).  A
    vote adds its dp share of the Gram matrix and softmax."""
    kind, a = parse_label(label)
    h = config.hidden_size
    if kind in ("ring", "ring_vote"):
        rows = (a["b"] if kind == "ring" else a["n"]) // dp
        out = encoder_cost(config, rows, a["s"], dtype_bytes,
                           sq=a["s"] // sp)
    elif kind == "reward_packed":
        out = deberta_cost(config, a["b"] // dp, a["l"], dtype_bytes, tp=tp)
    elif kind == "packed":
        out = encoder_cost(config, a["b"] // dp, a["l"], dtype_bytes, tp=tp)
        out["bytes_accessed"] += a["b"] // dp * a["l"] * 4
    elif kind == "embed":
        out = encoder_cost(config, a["b"] // dp, a["s"], dtype_bytes, tp=tp)
    elif kind in ("vote1", "many"):
        r = a.get("r", 1)
        out = encoder_cost(config, r * a["n"] // dp, a["s"], dtype_bytes,
                           tp=tp)
    else:
        raise ValueError(f"no cost model for bucket kind {kind!r}")
    if kind in ("vote1", "many", "ring_vote"):
        vote = vote_cost(a.get("r", 1), a["n"], h)
        out["flops"] += vote["flops"] / dp
        out["bytes_accessed"] += vote["bytes_accessed"] / dp
    return {"flops": float(out["flops"]),
            "bytes_accessed": float(out["bytes_accessed"])}


def bucket_cost(config, label: str, dtype_bytes: int = 2) -> Dict[str, float]:
    """``{"flops", "bytes_accessed", "product_flops"}`` of one dispatch
    at the bucket ``label`` (module doc)."""
    kind, a = parse_label(label)
    h = config.hidden_size
    if kind in ("embed", "ring"):
        # the ring computes the dense forward's work, split over sp
        out = encoder_cost(config, a["b"], a["s"], dtype_bytes)
        out["bytes_accessed"] += a["b"] * h * 4
        return out
    if kind == "packed":
        out = encoder_cost(config, a["b"], a["l"], dtype_bytes)
        # positions and segment ids ride beside the ids; no mask
        out["bytes_accessed"] += a["b"] * a["l"] * 4 + a["b"] * a["k"] * (
            4 + h * 4)
        return out
    if kind in ("vote1", "ring_vote"):
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
