"""The yardstick's operation and byte counts, and the H100's peaks.

Frozen copies, kept here so that a change to the program cannot change
what it is measured by: ``flops_per_answer`` of the port's
``bench/common.py``, and the attention and encoder products of its
``analysis/cost.py``, extended to DeBERTa's disentangled attention term
by term; a family (``families/<family>.py``) sums them per request.
Peaks: NVIDIA's H100 SXM data sheet, dense, at 700 W."""

from __future__ import annotations

from . import spec

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def flops_per_answer(cfg: dict, n: int, s: int) -> float:
    """Dense and attention matmul FLOPs of one N-candidate forward at s
    tokens (``bench/common.py``; 5.05e12 for bge-large at N=64,
    s=128)."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    dense = 2 * (4 * h * h + 2 * h * i)
    attn = 4 * s * h
    return float(cfg["num_hidden_layers"] * (dense + attn) * n * s)


def bert_sequence_flops(cfg: dict, tokens: int) -> float:
    """The products one sequence of ``tokens`` real tokens needs: q, k,
    v, the attention output and the two MLP layers (2 x tokens x in x
    out each), QK^T and PV (2 x tokens^2 x h each), per layer."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    dense = 2 * tokens * (4 * h * h + 2 * h * i)
    attention = 4 * tokens * tokens * h
    return float(cfg["num_hidden_layers"] * (dense + attention))


def deberta_sequence_flops(cfg: dict, tokens: int) -> float:
    """As ``bert_sequence_flops``, plus the disentangled terms each score
    needs (c2p: q_i . K_r[d(i, j)], p2c: k_j . Q_r[d(j, i)], 2 x
    tokens^2 x h each) and the reward head (pooler and classifier on
    the CLS state)."""
    h = cfg["hidden_size"]
    disentangled = cfg["num_hidden_layers"] * 4 * tokens * tokens * h
    head = 2 * h * h + 2 * h
    return bert_sequence_flops(cfg, tokens) + float(disentangled + head)


def deberta_table_flops(cfg: dict) -> float:
    """One forward's position projections of the relative table
    (``query_proj`` and ``key_proj`` over 2 x span rows, per layer),
    paid once per request whatever its rows."""
    h = cfg["hidden_size"]
    span = cfg["position_buckets"] if cfg["position_buckets"] > 0 else (
        cfg["max_relative_positions"] if cfg["max_relative_positions"] > 0
        else cfg["max_position_embeddings"])
    return float(cfg["num_hidden_layers"] * 2 * 2 * (2 * span) * h * h)


def request_flops(cfg: dict, lengths: list) -> float:
    """The products a request's sequences need, from their real token
    counts (no padding), as the configuration's family counts them."""
    return spec.family(cfg["family"]).request_flops(cfg, lengths)


def attention_launch(rows: int, s: int, heads: int, head_dim: int,
                     dtype_bytes: int = 2) -> tuple:
    """(FLOPs, bytes) of one attention launch over ``rows`` padded
    sequences of ``s`` tokens: QK^T and PV (4 x rows x s^2 x heads x
    head_dim); q, k and v read once, the output written once, the int32
    mask read once."""
    flops = 4 * rows * s * s * heads * head_dim
    nbytes = 4 * rows * s * heads * head_dim * dtype_bytes + rows * s * 4
    return float(flops), float(nbytes)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound, at the bf16 peak."""
    return max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_PER_S)
