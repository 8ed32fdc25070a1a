"""The port's device tally and soft votes against the JAX package's, on the
CPU: ``ops/consensus.py`` (``tally``, ``judge_confidence``,
``tally_batch``, ``judge_confidence_batch``, ``incremental_tally``,
``all_failed``), ``ops/votes.py::softmax_votes`` and
``parallel/batch.py::rescore_batch``, each on the same seeded numpy
inputs, within 1e-6 absolute (the reference's contract against its
exact-Decimal host tally, ``ops/consensus.py:16-17``).  The cases hold
failed judges (``vote_mask`` 0), an all-failed request (zeros, not NaN),
soft-vote ids of -1 and of ``n_choices`` or more (``jax.nn.one_hot``'s
zero rows) and rows with no valid alternative.  TF32 must stay off: it
would break 1e-6 on the card.
"""

from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.ops import consensus as ref_consensus
from llm_weighted_consensus_tpu.ops import votes as ref_votes
from llm_weighted_consensus_tpu.parallel.batch import (
    rescore_batch as ref_rescore_batch,
)
from llm_weighted_consensus_tpu_torch.ops import consensus, votes
from llm_weighted_consensus_tpu_torch.parallel.batch import rescore_batch

TOL = 1e-6
CPU = "cpu"


def _votes(rng, shape):
    """Rows summing to 1 (soft votes), with some one-hot rows."""
    v = rng.random(shape).astype(np.float32) ** 3
    v /= v.sum(axis=-1, keepdims=True)
    flat = v.reshape(-1, shape[-1])
    for r in range(0, len(flat), 3):
        flat[r] = 0.0
        flat[r, rng.integers(0, shape[-1])] = 1.0
    return flat.reshape(shape)


def _mask(rng, shape, all_failed_row=None):
    mask = (rng.random(shape) > 0.25).astype(np.float32)
    if all_failed_row is not None:
        mask[all_failed_row] = 0.0
    return mask


def _close(got: torch.Tensor, want) -> float:
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return float(np.max(np.abs(got - want), initial=0.0))


def _decimal_tally(votes, weights, mask):
    """The host tally's arithmetic in exact Decimal (the serving path's
    ``clients/score.py``), on the same f32 values."""
    n = votes.shape[1]
    cw = [Decimal(0)] * n
    for m in range(votes.shape[0]):
        w = Decimal(repr(float(weights[m]))) * Decimal(repr(float(mask[m])))
        for i in range(n):
            cw[i] += Decimal(repr(float(votes[m, i]))) * w
    total = sum(cw)
    conf = [c / total if total > 0 else Decimal(0) for c in cw]
    return [float(c) for c in cw], [float(c) for c in conf]


def test_tf32_stays_off():
    import llm_weighted_consensus_tpu_torch  # noqa: F401  (sets the flags)

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("masked", [False, True])
def test_tally_matches_jax_and_the_decimal_tally(seed, masked):
    rng = np.random.default_rng(seed)
    m, n = 8 + seed, 4 + 2 * seed
    v = _votes(rng, (m, n))
    w = rng.uniform(0.5, 3.0, m).astype(np.float32)
    mask = _mask(rng, m) if masked else None
    cw, conf = consensus.tally(v, w, mask, device=CPU)
    rcw, rconf = ref_consensus.tally(
        jnp.asarray(v), jnp.asarray(w),
        None if mask is None else jnp.asarray(mask))
    assert _close(cw, rcw) <= TOL and _close(conf, rconf) <= TOL
    dcw, dconf = _decimal_tally(
        v, w, mask if mask is not None else np.ones(m, np.float32))
    assert _close(cw, dcw) <= TOL and _close(conf, dconf) <= TOL
    assert abs(float(conf.sum()) - 1.0) <= TOL
    jc = consensus.judge_confidence(v, conf, device=CPU)
    assert _close(jc, ref_consensus.judge_confidence(
        jnp.asarray(v), rconf)) <= TOL


def test_all_failed_request_is_zero_not_nan():
    rng = np.random.default_rng(9)
    v = _votes(rng, (5, 3))
    w = np.ones(5, np.float32)
    mask = np.zeros(5, np.float32)
    cw, conf = consensus.tally(v, w, mask, device=CPU)
    assert torch.equal(cw, torch.zeros(3)) and torch.equal(conf, torch.zeros(3))
    assert bool(consensus.all_failed(mask, device=CPU))
    assert not bool(consensus.all_failed(np.eye(5)[0], device=CPU))
    assert bool(ref_consensus.all_failed(jnp.asarray(mask)))
    rcw, rconf = ref_consensus.tally(jnp.asarray(v), jnp.asarray(w),
                                     jnp.asarray(mask))
    assert np.array_equal(conf.numpy(), np.asarray(rconf))


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("b,m,n", [(1, 1, 2), (16, 8, 4), (33, 5, 7)])
def test_tally_batch_matches_jax(b, m, n, with_mask):
    rng = np.random.default_rng(b * 100 + m * 10 + n)
    v = _votes(rng, (b, m, n))
    w = rng.uniform(0.5, 3.0, (b, m)).astype(np.float32)
    mask = _mask(rng, (b, m), all_failed_row=0) if with_mask else None
    cw, conf = consensus.tally_batch(v, w, mask, device=CPU)
    rcw, rconf = ref_consensus.tally_batch(
        jnp.asarray(v), jnp.asarray(w),
        None if mask is None else jnp.asarray(mask))
    assert _close(cw, rcw) <= TOL and _close(conf, rconf) <= TOL
    sums = conf.sum(dim=1).numpy()
    live = (w * (mask if mask is not None else 1.0)).sum(axis=1) > 0
    assert np.all(np.abs(sums[live] - 1.0) <= TOL)
    assert np.all(sums[~live] == 0.0)
    jc = consensus.judge_confidence_batch(v, conf, device=CPU)
    assert _close(jc, ref_consensus.judge_confidence_batch(
        jnp.asarray(v), rconf)) <= TOL


@pytest.mark.parametrize("seed", range(3))
def test_incremental_tally_matches_jax_and_the_full_tally(seed):
    rng = np.random.default_rng(seed)
    m, n = 6, 5
    v = _votes(rng, (m, n))
    w = rng.uniform(0.5, 3.0, m).astype(np.float32)
    running = torch.zeros(n)
    ref_running = jnp.zeros(n)
    for j in range(m):
        running, conf = consensus.incremental_tally(
            running, v[j], float(w[j]), device=CPU)
        ref_running, ref_conf = ref_consensus.incremental_tally(
            ref_running, jnp.asarray(v[j]), float(w[j]))
        assert _close(running, ref_running) <= TOL
        assert _close(conf, ref_conf) <= TOL
    _, full = consensus.tally(v, w, device=CPU)
    assert _close(conf, full.numpy()) <= TOL


def _soft_inputs(rng, m, k, n):
    lp = np.log(rng.random((m, k)).astype(np.float32) + 1e-3)
    ids = rng.integers(0, n, (m, k)).astype(np.int64)
    valid = (rng.random((m, k)) > 0.3).astype(np.float32)
    ids[0, 0] = -1  # an invalid slot marked only by its id
    valid[0, 0] = 1.0
    ids[1, :2] = [n, n + 7]  # ids past n: jax.nn.one_hot's zero rows
    valid[1, :2] = 1.0
    valid[2] = 0.0  # no valid alternative: a zero row
    ids[3] = -1  # every id invalid: a zero row
    valid[3] = 1.0
    return lp, ids, valid


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("m,k,n", [(8, 20, 4), (40, 8, 16), (5, 3, 2)])
def test_softmax_votes_matches_jax(m, k, n, seed):
    rng = np.random.default_rng(seed)
    lp, ids, valid = _soft_inputs(rng, m, k, n)
    got = votes.softmax_votes(lp, ids, valid, n, device=CPU)
    want = ref_votes.softmax_votes(jnp.asarray(lp), jnp.asarray(ids),
                                   jnp.asarray(valid), n)
    assert _close(got, want) <= TOL
    sums = got.sum(dim=1).numpy()
    assert sums[2] == 0.0 and sums[3] == 0.0
    live = np.asarray(want).sum(axis=1) > 0
    assert np.all(np.abs(sums[live] - 1.0) <= TOL)


def test_torch_one_hot_is_not_the_reference_one_hot():
    """Why ``softmax_votes`` compares against ``arange``: torch's one_hot
    refuses -1 and an id past n (or widens, unsized), where JAX gives a
    zero row."""
    with pytest.raises(RuntimeError):
        torch.nn.functional.one_hot(torch.tensor([-1, 0]), 3)
    with pytest.raises(RuntimeError):
        torch.nn.functional.one_hot(torch.tensor([5]), 3)
    assert torch.nn.functional.one_hot(torch.tensor([5])).shape[-1] == 6
    got = votes.softmax_votes(np.zeros((1, 2), np.float32),
                              np.array([[-1, 5]]), np.ones((1, 2)), 3,
                              device=CPU)
    assert torch.equal(got, torch.zeros(1, 3))


@pytest.mark.parametrize("with_mask", [False, True])
def test_rescore_batch_matches_jax(with_mask):
    rng = np.random.default_rng(4)
    b, m, n = 257, 8, 4
    v = _votes(rng, (b, m, n))
    w = rng.uniform(0.5, 2.0, (b, m)).astype(np.float32)
    mask = _mask(rng, (b, m), all_failed_row=3) if with_mask else None
    cw, conf = rescore_batch(v, w, mask, device=CPU)
    rcw, rconf = ref_rescore_batch(v, w, mask)
    assert isinstance(cw, np.ndarray) and cw.dtype == np.float32
    assert np.max(np.abs(cw - np.asarray(rcw))) <= TOL
    assert np.max(np.abs(conf - np.asarray(rconf))) <= TOL
    assert conf.shape == (b, n) and np.isfinite(conf).all()


def test_the_card_is_the_default_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = np.eye(3, dtype=np.float32)
    w = np.ones(3, np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        consensus.tally(v, w)
    with pytest.raises(RuntimeError, match="cuda"):
        rescore_batch(v[None], w[None])
    with pytest.raises(RuntimeError, match="cuda"):
        votes.softmax_votes(np.zeros((1, 1)), np.zeros((1, 1), np.int64),
                            np.ones((1, 1)), 2)
    # a tensor given without a device stays where it is
    cw, _ = consensus.tally(torch.from_numpy(v), torch.from_numpy(w))
    assert cw.device.type == "cpu"
