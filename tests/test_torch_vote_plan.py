"""The cluster vote's plan and route, and its order of arithmetic, pinned
on the CPU.

``ops.kernels.vote_plan`` and ``vote_route`` are pure functions of
(R, N, D, dtype), so which vote kernel a served call launches, and how
the cluster kernel (``csrc/cosine_vote_sm90.cu``) splits D among its
blocks, is decided here, where no kernel can run.  ``_cluster_vote_model``
follows the kernel's order in numpy f32: partial sums over each block's
column slice, added across the cluster in rank order; it is held against
the reference's Pallas kernel (interpret mode, as ``test_torch_ops.py``
runs it) at 1e-6, the tolerance of the port's plain vote there.

The kernel itself is held against the plain version on the card
(``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.ops import kernels as jax_kernels
from llm_weighted_consensus_tpu_torch.ops import kernels

VOTE_TOL = 1e-6

# every shape the server makes: R up to the batcher's max_batch of 16,
# N in the gateway's [2, 256], D of bge_micro, bge-small, bge-base and
# bge-large
SERVED_R = range(1, 17)
SERVED_N = range(2, 257)
SERVED_D = (64, 384, 768, 1024)
DTYPES = (torch.float32, torch.bfloat16)


def _embeddings(shape, seed, spread=0.7):
    rng = np.random.default_rng(seed)
    *lead, n, d = shape
    center = rng.normal(size=(*lead, 1, d))
    return (center + spread * rng.normal(size=shape)).astype(np.float32)


def _cluster_vote_model(x, n_valid, temperature, plan):
    """The cluster kernel's order of arithmetic on x[N, D], in f32."""
    f32 = np.float32
    live = x[:n_valid].astype(f32)
    slices = [live[:, c * plan.cols:(c + 1) * plan.cols]
              for c in range(plan.cluster)]
    # 1. partial sums of squares per block, added in rank order
    sumsq = None
    for part in slices:
        p = np.sum(part * part, axis=1, dtype=f32)
        sumsq = p if sumsq is None else sumsq + p
    inv = (f32(1) / np.sqrt(sumsq + f32(1e-12))).astype(f32)
    # 2.-3. each block's column sum s of the normalised rows over its own
    # columns, then each row's partial dot - self as nx_i . (s - nx_i),
    # the self term taken out column by column; added in rank order
    off = None
    for part in slices:
        nx = part * inv[:, None]
        colsum = np.sum(nx, axis=0, dtype=f32)
        p = np.sum(nx * (colsum[None, :] - nx), axis=1, dtype=f32)
        off = p if off is None else off + p
    denom = f32(max(n_valid - 1, 1))
    logits = (off / denom) / f32(temperature)
    e = np.exp(logits - logits.max())
    conf = np.zeros(x.shape[0], f32)
    conf[:n_valid] = e / e.sum()
    return conf


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", SERVED_D)
def test_every_served_shape_takes_the_cluster_route(d, dtype):
    for r in SERVED_R:
        for n in SERVED_N:
            assert kernels.vote_route(r, n, d, dtype) == "cluster", (r, n)


@pytest.mark.parametrize(
    "r,n,d,dtype",
    [(2, 1024, 2048, torch.float32), (2, 1024, 2048, torch.bfloat16),
     (1, 16384, 1024, torch.float32), (8, 4096, 1024, torch.bfloat16),
     (1, 512, 8192, torch.float32)],
)
def test_past_the_plans_shared_memory_takes_the_block_route(r, n, d, dtype):
    plan = kernels.vote_plan(r, n, d, dtype)
    assert plan.cluster == kernels.VOTE_MAX_CLUSTER
    assert plan.smem_bytes > kernels.VOTE_SMEM_LIMIT
    assert kernels.vote_route(r, n, d, dtype) == "block"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", SERVED_D + (1000, 100, 7, 1, 4097, 16384))
def test_the_plan_covers_d_within_a_blocks_shared_memory(d, dtype):
    for r in (1, 2, 3, 8, 16, 40):
        for n in (2, 64, 256):
            plan = kernels.vote_plan(r, n, d, dtype)
            assert plan.cols % kernels.VOTE_COL_ALIGN == 0
            assert plan.cluster * plan.cols >= d
            # no block beyond the first that would own no column
            assert (plan.cluster - 1) * plan.cols < d or plan.cluster == 1
            assert plan.cluster in (1, 2, 4, 8, 16)
            assert plan.smem_bytes == kernels.vote_smem_bytes(
                n, plan.cols, plan.cluster, dtype)
            fits = plan.smem_bytes <= kernels.VOTE_SMEM_LIMIT
            assert fits == (kernels.vote_route(r, n, d, dtype) == "cluster")


def test_the_plan_takes_the_timed_cluster_sizes():
    # R * C up to 64 blocks: 16 blocks a request up to R = 4, 8 at the
    # main path's R = 8, 4 at R = 16; more where fewer would not fit (one
    # block cannot hold 64 rows of 1024 f32)
    for r, c in ((1, 16), (2, 16), (3, 16), (4, 16), (5, 8), (8, 8),
                 (16, 4), (40, 2)):
        assert kernels.vote_plan(r, 64, 1024, torch.float32).cluster == c
    assert kernels.vote_plan(8, 64, 1024, torch.float32)[:2] == (8, 128)
    assert kernels.vote_plan(16, 256, 1024, torch.float32)[:2] == (8, 128)
    # a narrow D keeps at least VOTE_MIN_COLS columns per block
    assert kernels.vote_plan(1, 64, 64, torch.float32)[:2] == (2, 32)
    assert kernels.vote_plan(1, 64, 384, torch.float32)[:2] == (8, 48)


def test_cpu_vote_counts_no_route():
    before = dict(kernels.cosine_vote.routes)
    launches = kernels.cosine_vote.launches
    kernels.cosine_vote(torch.from_numpy(_embeddings((2, 5, 64), 1)), 5)
    assert kernels.cosine_vote.routes == before
    assert kernels.cosine_vote.launches == launches


MODEL_CASES = [
    (n, d, t) for n in (2, 7, 64, 256) for d in (64, 384, 1024)
    for t in (0.05, 0.3)
]


@pytest.mark.parametrize("n,d,temperature", MODEL_CASES)
def test_the_kernels_order_matches_fused_cosine_vote(n, d, temperature):
    x = _embeddings((n, d), seed=n + d)
    ref = np.asarray(
        jax_kernels.fused_cosine_vote(jnp.asarray(x), temperature=temperature)
    )
    for r in (1, 16):
        plan = kernels.vote_plan(r, n, d, torch.float32)
        got = _cluster_vote_model(x, n, temperature, plan)
        np.testing.assert_allclose(got, ref, atol=VOTE_TOL)


@pytest.mark.parametrize("n,d", [(2, 1024), (7, 384), (64, 1024), (256, 64)])
def test_the_kernels_order_holds_on_near_duplicates(n, d):
    # candidates that nearly agree: every cosine near 1, the identity's
    # subtraction of the self term at its largest relative weight
    x = _embeddings((n, d), seed=3 * n + d, spread=1e-3)
    ref = np.asarray(jax_kernels.fused_cosine_vote(jnp.asarray(x), 0.05))
    plan = kernels.vote_plan(1, n, d, torch.float32)
    np.testing.assert_allclose(
        _cluster_vote_model(x, n, 0.05, plan), ref, atol=VOTE_TOL
    )


@pytest.mark.parametrize("n_valid", [1, 2, 50])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_the_kernels_order_at_every_cluster_size(cluster, n_valid):
    # any partition gives the plain vote; padding rows get exactly 0 and
    # a lone live row exactly 1
    n, d = 64, 1000
    x = _embeddings((n, d), seed=cluster)
    cols = -(-d // cluster)
    cols += -cols % kernels.VOTE_COL_ALIGN
    plan = kernels.VotePlan(cluster, cols, 0)
    got = _cluster_vote_model(x, n_valid, 0.05, plan)
    want = kernels.cosine_vote_plain(torch.from_numpy(x)[None], n_valid, 0.05)
    np.testing.assert_allclose(got, want[0].numpy(), atol=VOTE_TOL)
    assert (got[n_valid:] == 0).all()
    if n_valid == 1:
        assert got[0] == 1.0
