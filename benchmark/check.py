"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests the program answered in the window (``check_sample`` of
them, drawn from the seed; all of them when fewer completed) is run
through the plain reference (``reference/``) with the benchmark's own
weights in the form the configuration's family gives them
(``reference_state``: widened to float32 for BERT and DeBERTa), TF32
off.  The reference tokenizes each request's texts itself (the family's
tokenizer, at its ``max_tokens``), runs the family's model, and forms
each candidate's score: the centred mean cosine similarity (cosine), or
the centred reward (rm).  The served answer's confidences give the same
scores as T x log(confidence), centred.  The numbers compared are those the
cell's ``limits`` name, each with its limit, and three exact ones:

* ``score_rel_rms``: the root mean square of (served score - reference
  score) over every candidate of every sampled request, over the root
  mean square of the reference scores' spread within a request: the
  error as a share of what the vote tells apart;
* ``score_rms`` and ``score_gap``: the same error's root mean square and
  largest value, unscaled (read by ``calibrate.py``, compared where a
  cell's ``limits`` name them);
* ``tokens_off``: the largest |served token count - reference token
  count| over the sampled requests (the usage the server reports), 0;
* ``failed``: requests that got no answer or an error status, 0;
* ``checked``: the sampled requests compared, at least 1 (``is`` says
  which way each limit holds).

A served answer that is missing, malformed or of the wrong length reads
inf in every score number."""

from __future__ import annotations

import json
import math

import numpy as np

from . import spec
from .reference import vote
from .traffic.requests import model_texts


def reference_tokenizer(cfg: dict):
    return spec.family(cfg["family"]).reference_tokenizer(cfg)


def sample(records: list, seed: int, size: int) -> list:
    rng = np.random.default_rng([int(seed) % (2 ** 64), 3])
    if len(records) <= size:
        return list(records)
    picks = rng.choice(len(records), size=size, replace=False)
    return [records[i] for i in sorted(picks)]


def reference_scores(cfg: dict, ref_state: dict, tokenizer, texts: list,
                     device) -> tuple:
    """(centred scores [n] float64, token count) of one request."""
    import torch

    family = spec.family(cfg["family"])
    rows = [tokenizer.encode(t, family.max_tokens(cfg)) for t in texts]
    s = max(len(r) for r in rows)
    ids = torch.zeros((len(rows), s), dtype=torch.long)
    mask = torch.zeros((len(rows), s), dtype=torch.long)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = torch.tensor(r)
        mask[i, :len(r)] = 1
    ids, mask = ids.to(device), mask.to(device)
    with torch.no_grad():
        out = family.reference_scores(cfg, ref_state, ids, mask, device)
    return out.cpu(), int(mask.sum())


def compare(cfg: dict, mix: dict, records: list, ref_state: dict,
            seed: int, device, failed: int) -> dict:
    """{number: {"value", "limit"}} and ``correct`` for the window's
    answered records."""
    import torch

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        tokenizer = reference_tokenizer(cfg)
        picked = sample(records, seed, int(mix["check_sample"]))
        gap, tokens_off = 0.0, 0
        errors, spreads = [], []
        for rec in picked:
            want, tokens = reference_scores(cfg, ref_state, tokenizer,
                                            model_texts(rec.request),
                                            device)
            try:
                answer = json.loads(rec.body)
                conf = answer["confidence"]
                served_tokens = int(answer["usage"]["total_tokens"])
            except (ValueError, KeyError, TypeError):
                gap = math.inf
                continue
            if len(conf) != len(want):
                gap = math.inf
                continue
            got = vote.served_scores(conf, float(mix["temperature"]))
            diff = (got - want).abs()
            errors.append(diff)
            spreads.append(float(want.std()))
            err = float(diff.max())
            gap = max(gap, err if math.isfinite(err) else math.inf)
            tokens_off = max(tokens_off, abs(served_tokens - tokens))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    readings = {"score_gap": gap, "score_rms": math.inf,
                "score_rel_rms": math.inf}
    if errors and len(errors) == len(picked):
        flat = torch.cat(errors)
        rms = float(flat.pow(2).mean().sqrt())
        spread = float(np.sqrt(np.mean(np.square(spreads))))
        if math.isfinite(rms):
            readings["score_rms"] = rms
            readings["score_rel_rms"] = (rms / spread if spread > 0
                                         else math.inf)
    limits = mix["limits"]
    checks = {name: {"value": readings[name], "is": "<=", "limit": limit}
              for name, limit in limits.items()}
    checks["tokens_off"] = {"value": tokens_off, "is": "<=", "limit": 0}
    checks["failed"] = {"value": failed, "is": "<=", "limit": 0}
    checks["checked"] = {"value": len(picked), "is": ">=", "limit": 1}
    correct = all(c["value"] <= c["limit"] if c["is"] == "<=" else
                  c["value"] >= c["limit"] for c in checks.values())
    extra = {k: v for k, v in readings.items() if k not in limits}
    return {"correct": bool(correct), "checks": checks, "extra": extra}
