"""Archive batch re-scoring: recompute consensus over stored completions.

Counterpart of ``llm_weighted_consensus_tpu/archive/rescore.py``
(BASELINE config 4: re-score 10k archived completions).  When judge
weights change, every archived score completion's consensus is
recomputed without re-querying any judge: the votes are stored per judge
choice (``message.vote``), so re-scoring is device math:

1. extract the [M, N] vote matrix + weight vector per archived completion;
2. stack them into one [B, M, N] batch per (M, N) shape;
3. one batched tally on the device (``parallel.batch.rescore_batch``);
4. write per-candidate weight/confidence back into wire form.

``revote=True`` first re-extracts the soft votes from the stored judge
logprobs instead of trusting the stored vote vectors: the host re-aligns
each judge's ballot key against its archived ``logprobs.content`` (the
alignment the live path uses, ``ballot/vote.py``), and the numeric tail
(exp over the ``top_logprobs`` alternatives, scatter to candidates,
normalise) runs as one batched ``ops.votes.softmax_votes`` over every
judge of every completion.  It needs the archived ballots
(``InMemoryArchive.put_ballot``, fed by ``ScoreClient.ballot_sink``);
judges without a ballot record, content key or logprobs keep their
stored vote row.

Results are ``Decimal(repr(float(x)))`` of the f32 outputs, as in the
reference.  The card sums in another order than XLA's CPU einsum, so the
last digits of these strings may differ between the packages: they agree
within 1e-6, not byte for byte.
"""

from __future__ import annotations

from decimal import Decimal
from typing import Optional

import numpy as np

from ..ballot import PrefixTree
from ..ballot.vote import (
    align_key_token,
    final_letter,
    find_key,
    soft_vote_alternatives,
)

MAX_LOGPROB_FAN = 20  # top_logprobs hard cap (llm/mod.rs:455-467)


def _judge_choices(completion) -> list:
    # candidates carry model_index=None (the score client's initial
    # chunk); judge choices always carry their judge's model_index
    return [c for c in completion.choices if c.model_index is not None]


def vote_matrix(completion, max_judges: Optional[int] = None):
    """Archived score ChatCompletion -> (votes[M, N], weights[M], mask[M]).

    N = candidate choices (index < first judge index); judges without a
    stored vote (errored) get zero rows + zero mask.
    """
    judge_choices = _judge_choices(completion)
    n_choices = len(completion.choices) - len(judge_choices)
    m = max(len(judge_choices), 1)
    if max_judges is not None:
        m = max_judges
    votes = np.zeros((m, n_choices), dtype=np.float32)
    weights = np.zeros((m,), dtype=np.float32)
    mask = np.zeros((m,), dtype=np.float32)
    for i, choice in enumerate(judge_choices[:m]):
        if choice.weight is not None:
            weights[i] = float(choice.weight)
        vote = getattr(choice.message, "vote", None)
        if vote is not None:
            votes[i, : len(vote)] = [float(v) for v in vote[:n_choices]]
            mask[i] = 1.0
    return votes, weights, mask


def revote_inputs(completion, ballots, m: int, n_choices: int):
    """Host-side alignment for device re-extraction: per judge row, the
    ``softmax_votes`` inputs (logprobs[m, K], candidate_ids[m, K],
    valid[m, K]) plus use[m] — True where re-extraction is possible.

    One-hot fallbacks (no alignable logprobs, client.rs:1796-1798) are
    encoded as a single alternative with logprob 0: exp(0)=1 normalizes to
    the one-hot row, so the device needs no special case.
    """
    k = MAX_LOGPROB_FAN
    lp = np.zeros((m, k), dtype=np.float32)
    cid = np.full((m, k), -1, dtype=np.int64)
    valid = np.zeros((m, k), dtype=np.float32)
    use = np.zeros((m,), dtype=bool)
    for i, choice in enumerate(_judge_choices(completion)[:m]):
        key_indices = (ballots or {}).get(choice.model_index)
        if not key_indices:
            continue
        keys = [key for key, _ in key_indices]
        with_ticks, without_ticks = PrefixTree.regex_patterns(keys)
        content = choice.message.content if choice.message else None
        key = find_key(content, with_ticks, without_ticks)
        if key is None:
            continue
        branch = PrefixTree.leaf_branch_of(key_indices, key)
        final = final_letter(key)
        tokens = (
            choice.logprobs.content if choice.logprobs is not None else None
        )
        alts = []
        aligned = align_key_token(key, final, tokens)
        if aligned is not None:
            alts = soft_vote_alternatives(branch, *aligned)
        # stale/corrupt ballot records could map outside this completion's
        # candidate range; such rows keep their stored vote
        alts = [a for a in alts if 0 <= a[0] < n_choices]
        if not alts:
            leaf = branch.get(final)
            if not isinstance(leaf, int) or not 0 <= leaf < n_choices:
                continue
            alts = [(leaf, 0.0)]
        for slot, (leaf, logprob) in enumerate(alts[:k]):
            lp[i, slot] = float(logprob)
            cid[i, slot] = leaf
            valid[i, slot] = 1.0
        use[i] = True
    return lp, cid, valid, use


def rescore_archive(
    store,
    *,
    weight_overrides: Optional[dict] = None,
    ids: Optional[list] = None,
    revote: bool = False,
    device=None,
) -> dict:
    """Re-tally every archived score completion, one device batch per
    (M, N) shape, on ``device`` (the card unless the caller passes
    ``"cpu"``).

    ``weight_overrides``: {judge model id -> new weight} applied before the
    tally (the re-weighting scenario).  ``revote=True`` re-extracts soft
    votes from stored logprobs on the device first (see module doc).
    Returns {completion id: {"weight": [...], "confidence": [...]}} aligned
    to candidate indices.
    """
    from ..parallel.batch import rescore_batch

    ids = list(ids if ids is not None else store.score_ids())
    groups: dict = {}
    for cid in ids:
        completion = store.score_completion(cid)
        if completion is None:  # evicted/unknown id: nothing to re-tally
            continue
        votes, weights, mask = vote_matrix(completion)
        if weight_overrides:
            for i, choice in enumerate(_judge_choices(completion)):
                if choice.model in weight_overrides and i < len(weights):
                    weights[i] = float(weight_overrides[choice.model])
        groups.setdefault(votes.shape, []).append((cid, votes, weights, mask))

    results: dict = {}
    for shape, rows in groups.items():
        batch_votes = np.stack([r[1] for r in rows])
        batch_weights = np.stack([r[2] for r in rows])
        batch_mask = np.stack([r[3] for r in rows])
        if revote:
            batch_votes, batch_mask = _revote_group(
                store, rows, batch_votes, batch_mask, shape, device
            )
        cw, conf = rescore_batch(
            batch_votes, batch_weights, batch_mask, device=device
        )
        for i, (cid, *_rest) in enumerate(rows):
            results[cid] = {
                "weight": [Decimal(repr(float(x))) for x in cw[i]],
                "confidence": [Decimal(repr(float(x))) for x in conf[i]],
            }
    return results


def _revote_group(store, rows, batch_votes, batch_mask, shape, device):
    """Device re-extraction for one (M, N) shape group: one batched
    ``softmax_votes`` over every judge of every completion, under the
    device's launch lock; rows where re-extraction isn't possible keep
    their stored vote + mask."""
    import torch

    from ..models.bert import resolve_device
    from ..models.graphs import launch_lock
    from ..ops.votes import softmax_votes

    m, n = shape
    b = len(rows)
    lp = np.zeros((b, m, MAX_LOGPROB_FAN), dtype=np.float32)
    cid = np.full((b, m, MAX_LOGPROB_FAN), -1, dtype=np.int64)
    valid = np.zeros((b, m, MAX_LOGPROB_FAN), dtype=np.float32)
    use = np.zeros((b, m), dtype=bool)
    for bi, (completion_id, *_rest) in enumerate(rows):
        completion = store.score_completion(completion_id)
        if completion is None:  # vanished mid-pass: keep stored votes
            continue
        ballots = store.score_ballots(completion_id)
        lp[bi], cid[bi], valid[bi], use[bi] = revote_inputs(
            completion, ballots, m, n
        )
    if not use.any():
        return batch_votes, batch_mask
    device = resolve_device(device)
    with launch_lock(device), torch.inference_mode():
        device_votes = softmax_votes(
            lp.reshape(b * m, MAX_LOGPROB_FAN),
            cid.reshape(b * m, MAX_LOGPROB_FAN),
            valid.reshape(b * m, MAX_LOGPROB_FAN),
            n,
            device=device,
        ).cpu().numpy().reshape(b, m, n)
    votes = np.where(use[:, :, None], device_votes, batch_votes)
    mask = np.where(use, 1.0, batch_mask).astype(batch_mask.dtype)
    return votes, mask


def apply_rescore(store, results: dict) -> int:
    """Write re-scored weights/confidences back into the archived wire
    objects (the checkpoint-update step).  Returns completions updated."""
    updated = 0
    for cid, scores in results.items():
        completion = store.score_completion(cid)
        if completion is None:
            continue
        n = len(scores["confidence"])
        for choice in completion.choices:
            if choice.index < n and choice.model_index is None:
                choice.weight = scores["weight"][choice.index]
                choice.confidence = scores["confidence"][choice.index]
        updated += 1
    return updated
