"""The vote with a count per request, on the CPU, against the reference.

``ops.kernels.cosine_vote(emb, n_valid)`` takes ``n_valid`` as an int or
as an int32 tensor [R], one count per request (one stream dispatch holds
streams of different lengths).  On the CPU the wrapper runs its plain
version; here it is held against the JAX package's ``masked_cosine_vote``
vmapped over the prefix masks the counts describe, at the shapes the
streaming path makes (R in {1, 2, 8, 16}, CAP in {16, 32, 64, 128}), f32,
within 1e-5 (f32 Grams summed in different orders).  Rows at and past a
request's count are exactly 0, a count of 0 gives a request of zeros, the
scalar path equals a tensor of equal counts exactly, and the wrapper
refuses counts of the wrong type or shape.  The kernels' side of the same
contract is in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.ops.similarity import (
    masked_cosine_vote as ref_masked_vote,
)
from llm_weighted_consensus_tpu_torch.ops.kernels import (
    cosine_vote,
    cosine_vote_plain,
)

TOL = 1e-5


def _case(r: int, cap: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    # candidates cluster around 3 answers, as a vote's inputs do
    centers = rng.normal(size=(3, d))
    emb = centers[rng.integers(0, 3, (r, cap))] + 0.4 * rng.normal(
        size=(r, cap, d))
    counts = rng.integers(1, cap + 1, r)
    counts[0] = 1
    counts[-1] = cap
    return emb.astype(np.float32), counts.astype(np.int32)


def _reference(emb, counts, temperature):
    valid = (np.arange(emb.shape[1])[None, :] < counts[:, None]).astype(
        np.float32)
    vote = jax.vmap(lambda e, v: ref_masked_vote(e, v, temperature))
    return np.asarray(vote(jnp.asarray(emb), jnp.asarray(valid)))


@pytest.mark.parametrize("r", [1, 2, 8, 16])
@pytest.mark.parametrize("cap", [16, 32, 64, 128])
def test_per_request_counts_match_the_reference(r, cap):
    emb, counts = _case(r, cap, 64, seed=r * 1000 + cap)
    for temperature in (0.05, 0.7):
        want = _reference(emb, counts, temperature)
        got = cosine_vote(torch.from_numpy(emb), torch.from_numpy(counts),
                          temperature).numpy()
        assert np.max(np.abs(got - want)) <= TOL
        for i, c in enumerate(counts):
            assert np.all(got[i, c:] == 0.0)
            assert abs(got[i, :c].sum() - 1.0) < 1e-5


def test_full_width_counts_match_the_reference():
    emb, counts = _case(8, 128, 1024, seed=3)
    want = _reference(emb, counts, 0.05)
    got = cosine_vote(torch.from_numpy(emb), torch.from_numpy(counts)).numpy()
    assert np.max(np.abs(got - want)) <= TOL


def test_scalar_count_equals_a_vector_of_equal_counts():
    emb, _ = _case(8, 32, 64, seed=9)
    t = torch.from_numpy(emb)
    for n in (1, 5, 32):
        scalar = cosine_vote(t, n, 0.05)
        vector = cosine_vote(t, torch.full((8,), n, dtype=torch.int32), 0.05)
        assert torch.equal(scalar, vector)


def test_zero_and_oversized_counts_clamp():
    emb, _ = _case(3, 16, 64, seed=11)
    t = torch.from_numpy(emb)
    got = cosine_vote(t, torch.tensor([0, 16, 99], dtype=torch.int32), 0.05)
    assert torch.equal(got[0], torch.zeros(16))
    assert torch.equal(got[1], cosine_vote(t[1:2], 16, 0.05)[0])
    assert torch.equal(got[2], cosine_vote(t[2:3], 16, 0.05)[0])
    assert torch.equal(got, cosine_vote_plain(
        t, torch.tensor([0, 16, 16], dtype=torch.int32), 0.05))


@pytest.mark.parametrize("bad", [
    torch.tensor([1, 2], dtype=torch.int64),
    torch.tensor([1, 2, 3], dtype=torch.int32),
    torch.tensor([[1, 2]], dtype=torch.int32),
])
def test_the_wrapper_refuses_malformed_counts(bad):
    emb = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError):
        cosine_vote(emb, bad, 0.05)
