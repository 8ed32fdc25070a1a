"""Fit per-judge consensus weights from ledger shards.

The port's copy of ``llm_weighted_consensus_tpu/train/fit.py``.  The
model is the serving tally itself: a candidate's score is the weighted
sum of the panel's soft votes, so the learner fits the weight vector
``w`` that makes the tally's argmax match the labels,

    logits[r, i] = sum_j w_j * vote[r, j, i]        (w_j = softplus(theta_j))
    loss         = masked softmax cross-entropy(logits, label[r])
                   + l2 * sum_j theta_j**2

batched over every record at once as one torch optimization
(``torch.optim.Adam`` on ``theta`` from 0) on one device (the card
unless the caller asks for the CPU) or, with ``mesh``, with the records
dp-sharded over a device mesh and ``theta`` replicated, as the
reference's ``mesh`` argument does.

Numerics against the reference's optax Adam: torch folds the bias
corrections into the step size and optax divides the moments; the two
agree in exact arithmetic, not bit for bit in f32.  The matmuls here are
f32 with TF32 off (torch's default for matmuls; ``fit_weights`` refuses
to run with it on), so a fit on the card matches one on the CPU to f32
rounding.

Labels per record, in priority order: an explicit ``labels`` mapping
(record id -> candidate index), the record's own ``label`` field, else
the record's consensus ``winner`` (self-consistency).

The emitted table is versioned by content (``weights/live.py``) and
hot-swaps into the scoring path via ``PUT /v1/weights``.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np


class Dataset:
    """Dense arrays over ``R`` records x ``J`` judges x ``N`` candidates."""

    __slots__ = (
        "votes", "vote_mask", "cand_mask", "labels", "sample_weight",
        "judge_ids", "base_weights", "skipped",
    )

    def __init__(
        self, votes, vote_mask, cand_mask, labels, sample_weight,
        judge_ids, base_weights, skipped,
    ) -> None:
        self.votes = votes            # [R, J, N] f32
        self.vote_mask = vote_mask    # [R, J]    f32: the judge voted
        self.cand_mask = cand_mask    # [R, N]    f32: the candidate exists
        self.labels = labels          # [R]       i32
        self.sample_weight = sample_weight  # [R] f32: 0 = padding
        self.judge_ids = judge_ids    # [J] stable sorted judge ids
        # mean observed serving weight per judge: the "base" baseline the
        # fitted table is evaluated against
        self.base_weights = base_weights  # [J] f32
        self.skipped = skipped

    @property
    def n_records(self) -> int:
        return int(self.sample_weight.sum())

    def subset(self, index) -> "Dataset":
        return Dataset(
            self.votes[index], self.vote_mask[index], self.cand_mask[index],
            self.labels[index], self.sample_weight[index],
            self.judge_ids, self.base_weights, self.skipped,
        )


def _record_label(record: dict, labels: Optional[dict]):
    if labels is not None:
        label = labels.get(record.get("id"))
        if label is not None:
            return int(label)
    label = record.get("label")
    if label is not None:
        return int(label)
    winner = record.get("winner")
    return int(winner) if winner is not None else None


def build_dataset(
    records: Iterable[dict], labels: Optional[dict] = None
) -> Optional[Dataset]:
    """Ledger records -> dense training arrays.  Records with no usable
    label, fewer than two candidates, or no voting judge are skipped and
    counted: all-failed records can never vote."""
    rows = []
    skipped = 0
    judge_ids: set = set()
    max_n = 0
    for record in records:
        label = _record_label(record, labels)
        n = int(record.get("n_choices") or 0)
        judges = [
            j
            for j in (record.get("judges") or [])
            if j.get("model") and j.get("vote")
        ]
        if (
            record.get("all_failed")
            or n < 2
            or label is None
            or not (0 <= label < n)
            or not judges
        ):
            skipped += 1
            continue
        rows.append((label, n, judges))
        max_n = max(max_n, n)
        judge_ids.update(j["model"] for j in judges)
    if not rows:
        return None
    ids = sorted(judge_ids)
    index = {jid: k for k, jid in enumerate(ids)}
    R, J, N = len(rows), len(ids), max_n
    votes = np.zeros((R, J, N), np.float32)
    vote_mask = np.zeros((R, J), np.float32)
    cand_mask = np.zeros((R, N), np.float32)
    out_labels = np.zeros(R, np.int32)
    base_sum = np.zeros(J, np.float64)
    base_count = np.zeros(J, np.float64)
    for r, (label, n, judges) in enumerate(rows):
        out_labels[r] = label
        cand_mask[r, :n] = 1.0
        for judge in judges:
            k = index[judge["model"]]
            vote = judge["vote"][:n]
            votes[r, k, : len(vote)] = np.asarray(vote, np.float32)
            vote_mask[r, k] = 1.0
            weight = judge.get("weight")
            if weight is not None:
                base_sum[k] += float(weight)
                base_count[k] += 1.0
    base = np.where(base_count > 0, base_sum / np.maximum(base_count, 1), 1.0)
    return Dataset(
        votes, vote_mask, cand_mask, out_labels, np.ones(R, np.float32),
        ids, base.astype(np.float32), skipped,
    )


def tally_accuracy(dataset: Dataset, weights: np.ndarray) -> float:
    """Held-out consensus accuracy under a weight vector: the fraction
    of records whose weighted-tally argmax equals the label.  Pure
    numpy: the evaluation must not depend on the fit's device."""
    w = np.asarray(weights, np.float32)
    scores = np.einsum(
        "rjn,j,rj->rn", dataset.votes, w, dataset.vote_mask
    )
    scores = np.where(dataset.cand_mask > 0, scores, -np.inf)
    hit = (scores.argmax(axis=1) == dataset.labels).astype(np.float64)
    denom = float(dataset.sample_weight.sum())
    return float((hit * dataset.sample_weight).sum() / denom) if denom else 0.0


def _dp_shards(dataset: Dataset, mesh) -> list:
    """The records split over the mesh's dp axis: a ragged tail padded
    with zero-``sample_weight`` rows (``cand_mask`` 1, so their softmax
    stays finite; they add nothing to the loss or its gradient), each dp
    row's block -> {name: array} per dp shard, with its device."""
    dp = mesh.shape["dp"]
    arrays = {
        "votes": dataset.votes, "vote_mask": dataset.vote_mask,
        "cand_mask": dataset.cand_mask, "labels": dataset.labels,
        "sample_weight": dataset.sample_weight,
    }
    r = dataset.votes.shape[0]
    pad = (-r) % dp
    if pad:
        arrays = {
            name: np.concatenate([a, np.full(
                (pad,) + a.shape[1:], 1.0 if name == "cand_mask" else 0,
                a.dtype)])
            for name, a in arrays.items()
        }
    per = (r + pad) // dp
    return [({name: a[d * per:(d + 1) * per] for name, a in arrays.items()},
             mesh.device(dp=d)) for d in range(dp)]


def fit_losses(dataset: Dataset, steps: int = 300, lr: float = 0.1,
               l2: float = 1e-4, device=None, mesh=None) -> tuple:
    """``(weights, losses)``: ``fit_weights``'s result and the loss
    before each of its steps, as floats."""
    import torch

    from ..models.bert import resolve_device

    if mesh is not None:
        shards = _dp_shards(dataset, mesh)
        device = torch.device(shards[0][1])
    else:
        device = resolve_device(device)
        shards = [({"votes": dataset.votes, "vote_mask": dataset.vote_mask,
                    "cand_mask": dataset.cand_mask, "labels": dataset.labels,
                    "sample_weight": dataset.sample_weight}, device)]
    if any(torch.device(d).type == "cuda" for _, d in shards) and (
            torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "fit_weights runs its f32 matmuls without TF32; set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )

    def put(a, dtype, on):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=on)

    parts = []
    for arrays, on in shards:
        parts.append({
            "votes": put(arrays["votes"], torch.float32, on),
            "vote_mask": put(arrays["vote_mask"], torch.float32, on),
            "cand_mask": put(arrays["cand_mask"], torch.float32, on),
            "labels": put(arrays["labels"], torch.int64, on),
            "sample_weight": put(arrays["sample_weight"], torch.float32, on),
            "masked": torch.full((), -1e9, dtype=torch.float32, device=on),
            "zero": torch.zeros((), dtype=torch.float32, device=on),
        })
    denom = torch.clamp(sum(
        p["sample_weight"].sum().to(device) for p in parts), min=1.0)
    zero = parts[0]["zero"]

    # theta replicated: each dp shard reads it through a differentiable
    # copy, so its gradient sums every shard's records
    theta = torch.zeros(len(dataset.judge_ids), dtype=torch.float32,
                        device=device, requires_grad=True)
    # optax.adam's defaults: betas (0.9, 0.999), eps 1e-8
    optimizer = torch.optim.Adam([theta], lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    losses = []
    for _ in range(max(1, int(steps))):
        total = None
        for p in parts:
            th = theta.to(p["zero"].device)
            w = torch.logaddexp(th, p["zero"])  # softplus, as jax's
            logits = torch.einsum("rjn,j,rj->rn", p["votes"], w,
                                  p["vote_mask"])
            logits = torch.where(p["cand_mask"] > 0, logits, p["masked"])
            ce = -torch.log_softmax(logits, dim=-1).gather(
                1, p["labels"][:, None])[:, 0]
            part = (ce * p["sample_weight"]).sum().to(device)
            total = part if total is None else total + part
        loss = total / denom + l2 * torch.sum(theta**2)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    with torch.no_grad():
        w = np.asarray(torch.logaddexp(theta, zero).cpu().numpy(),
                       np.float64)
    mean = w.mean() or 1.0
    return (w / mean).astype(np.float32), [float(x) for x in losses]


def fit_weights(
    dataset: Dataset,
    steps: int = 300,
    lr: float = 0.1,
    l2: float = 1e-4,
    mesh=None,
    device=None,
) -> np.ndarray:
    """One batched optimization over every record -> per-judge weight
    vector (positive via softplus, mean-normalized to 1.0 so the fitted
    table composes with [min, max] clamps the way static weights do), on
    ``device`` (CUDA unless ``"cpu"``).  ``mesh`` (a
    ``parallel.mesh.Mesh``) shards the records over its dp axis, a
    ragged tail padded with zero-weight rows, and replicates theta: the
    same function, its per-shard sums added on the first dp device."""
    return fit_losses(dataset, steps=steps, lr=lr, l2=l2, device=device,
                      mesh=mesh)[0]


def holdout_split(dataset: Dataset, every: int = 4) -> tuple:
    """Deterministic (train, holdout) split: every ``every``-th record
    holds out, reproducible across processes with no RNG to seed."""
    index = np.arange(dataset.votes.shape[0])
    hold = index % max(2, int(every)) == 0
    return dataset.subset(~hold), dataset.subset(hold)


def fit_from_records(
    records: Iterable[dict],
    labels: Optional[dict] = None,
    steps: int = 300,
    lr: float = 0.1,
    holdout_every: int = 4,
    mesh=None,
    device=None,
) -> Optional[dict]:
    """records -> the versioned weights report: the fitted table plus
    held-out consensus accuracy under fitted / uniform / base weights."""
    dataset = build_dataset(records, labels)
    if dataset is None:
        return None
    train, hold = holdout_split(dataset, holdout_every)
    if train.n_records == 0 or hold.n_records == 0:
        train = hold = dataset
    fitted = fit_weights(train, steps=steps, lr=lr, mesh=mesh, device=device)
    uniform = np.ones(len(dataset.judge_ids), np.float32)
    weights = {
        jid: round(float(w), 6)
        for jid, w in zip(dataset.judge_ids, fitted)
    }
    from ..weights.live import weights_version

    return {
        "version": weights_version(weights),
        "weights": weights,
        "judges": list(dataset.judge_ids),
        "records": dataset.n_records,
        "train_records": train.n_records,
        "holdout_records": hold.n_records,
        "skipped": dataset.skipped,
        "accuracy": {
            "fitted": round(tally_accuracy(hold, fitted), 4),
            "uniform": round(tally_accuracy(hold, uniform), 4),
            "base": round(tally_accuracy(hold, dataset.base_weights), 4),
        },
    }


def fit_from_ledger(
    disk_dir: str,
    labels: Optional[dict] = None,
    steps: int = 300,
    lr: float = 0.1,
    holdout_every: int = 4,
    mesh=None,
    device=None,
) -> Optional[dict]:
    """Stream every shard under ``disk_dir`` through ``build_dataset``
    and fit; the shards read and torn lines ride the report."""
    from .feed import LedgerFeed

    feed = LedgerFeed(disk_dir)
    report = fit_from_records(
        feed.records(),
        labels,
        steps=steps,
        lr=lr,
        holdout_every=holdout_every,
        mesh=mesh,
        device=device,
    )
    if report is not None:
        report["shards"] = feed.shards_read
        report["torn"] = feed.torn
    return report
