"""Training-table population from archived outcomes: the learning half
of the trained-weights loop.

Counterpart of ``llm_weighted_consensus_tpu/weights/learning.py``.  The
reference's upstream defines the trained-weight lookup (embed the
prompt, take the ``top`` nearest rows of a per-judge table) and leaves
row production external.  Here the loop closes in the service:

    serve -> archive (completion + request + ballots)
          -> ``populate_from_archive``  (this module)
          -> TrainingTableStore rows
          -> TorchTrainingTableFetcher lookups on the next request

A table row is (prompt embedding, outcome score in [0, 1]).  The outcome
score per judge:

* **supervised** — when the caller knows the correct candidate
  (``labels[completion_id] = candidate index``): the judge's vote mass on
  that candidate, ``vote_j[label]``;
* **self-consistency** — otherwise: agreement with the panel's final
  consensus, ``sum_i vote_j[i] * confidence_i`` — judges that vote with the
  (weighted) majority earn weight, dissenters lose it.

All prompts embed as ONE ``embedder.embed_texts`` call at the panel's
``max_tokens`` (on the card, the encoder's attention runs in the
hand-written kernel of ``csrc/attention_sm90.cu``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def judge_alignment_scores(completion, label: Optional[int] = None) -> dict:
    """{judge model_index: outcome score in [0, 1]} for one archived score
    completion.  Judges without a stored vote (errored) are omitted."""
    candidates = {}
    judges = []
    for choice in completion.choices:
        if choice.model_index is None:
            candidates[choice.index] = choice
        else:
            judges.append(choice)
    out: dict = {}
    for judge in judges:
        vote = getattr(judge.message, "vote", None)
        if vote is None:
            continue
        if label is not None:
            # reject negative sentinels too: vote[-1] would silently train
            # against the LAST candidate
            score = float(vote[label]) if 0 <= label < len(vote) else 0.0
        else:
            score = 0.0
            for i, v in enumerate(vote):
                cand = candidates.get(i)
                if cand is not None and cand.confidence is not None:
                    score += float(v) * float(cand.confidence)
        out[judge.model_index] = min(max(score, 0.0), 1.0)
    return out


def populate_from_archive(
    store,
    embedder,
    model,
    table_store,
    *,
    ids: Optional[list] = None,
    labels: Optional[dict] = None,
    max_tokens: Optional[int] = None,
) -> int:
    """Learn table rows for ``model``'s judges from archived completions.

    ``store``: the completions archive (must hold requests too — gateway
    ARCHIVE_WRITE stores them); ``model``: the validated panel whose judges
    (matched by judge id) get rows keyed by their ``training_table_id``;
    ``labels``: optional {completion_id: correct candidate index} for
    supervised scores.

    Judges match their history two ways: exact judge id, or — when the
    archived request carried an inline panel — the archived judge's
    ``training_table_id`` (the WEIGHT-INVARIANT judge identity,
    llm/mod.rs:524-536), so re-weighted panels keep learning from the same
    judges' history.  Idempotence is scoped per (table, completion): a
    table never ingests the same completion twice, while a panel with NEW
    table ids still learns from already-processed history.  Returns the
    number of rows added.
    """
    from ..identity.model import ModelBase

    # dedup: repeated ids in one call would pass the is_ingested scan
    # twice (marks only land after embedding) and double-insert rows
    ids = list(dict.fromkeys(ids if ids is not None else store.score_ids()))
    by_judge_id = {llm.id: llm for llm in model.llms}
    if max_tokens is None:
        # match the LOOKUP's truncation (panel embeddings config): stored
        # and query embeddings of the same prompt must be the same vector
        max_tokens = getattr(
            getattr(model.weight, "embeddings", None), "max_tokens", None
        )

    texts = []
    per_completion = []  # (completion id, text position, {table_id: score})
    for cid in ids:
        completion = store.score_completion(cid)
        request = store.score_request(cid)
        if completion is None or request is None:
            continue
        # weight-invariant fallback identities from the archived panel
        archived_by_id: dict = {}
        archived_model = getattr(request, "model", None)
        if isinstance(archived_model, ModelBase):
            try:
                validated = archived_model.into_model_validate()
                archived_by_id = {llm.id: llm for llm in validated.llms}
            except Exception:
                pass
        scores = judge_alignment_scores(
            completion, (labels or {}).get(cid)
        )
        rows: dict = {}
        for choice in completion.choices:
            if choice.model_index is None or choice.model_index not in scores:
                continue
            llm = by_judge_id.get(choice.model) or archived_by_id.get(
                choice.model
            )
            if llm is None or not llm.training_table_id:
                continue
            if table_store.is_ingested(f"{llm.training_table_id}/{cid}"):
                continue
            rows[llm.training_table_id] = scores[choice.model_index]
        if not rows:
            continue
        per_completion.append((cid, len(texts), rows))
        texts.append(request.template_content())

    if not texts:
        return 0
    embeddings = embedder.embed_texts(texts, max_tokens=max_tokens)

    # group rows per table so each table concatenates ONCE (appending row
    # by row would copy the whole table per completion — quadratic)
    by_table: dict = {}
    for cid, pos, rows in per_completion:
        for table_id, score in rows.items():
            embs, scores, cids = by_table.setdefault(table_id, ([], [], []))
            embs.append(embeddings[pos])
            scores.append(score)
            cids.append(cid)
    added = 0
    for table_id, (embs, scores, cids) in by_table.items():
        table_store.add_rows(
            table_id, np.stack(embs), np.asarray(scores, dtype=np.float32)
        )
        # mark ONLY what actually landed: marking up front would poison
        # idempotence if an add_rows raises (e.g. embedding-dim mismatch
        # after an embedder swap) and strand that history as unlearnable
        for cid in cids:
            table_store.mark_ingested(f"{table_id}/{cid}")
        added += len(scores)
    return added
