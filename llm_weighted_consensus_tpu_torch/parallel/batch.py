"""Archive batch re-scoring on one device (BASELINE config 4).

Counterpart of ``llm_weighted_consensus_tpu/parallel/batch.py``:
re-scoring thousands of archived score requests is one batched tally,
and the whole batch crosses to the device once.  The reference shards
the batch over its mesh; the port runs on one card (its mesh is a later
slice), so there is no ``mesh`` argument.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import consensus


def rescore_batch(
    votes: np.ndarray,
    weights: np.ndarray,
    vote_mask: Optional[np.ndarray] = None,
    device=None,
):
    """votes[B, M, N], weights[B, M] -> (choice_weight[B, N],
    confidence[B, N]) as f32 numpy arrays.

    The inputs are uploaded once and tallied on ``device`` (the card
    unless the caller passes ``"cpu"``), under the device's launch lock
    (``models.graphs.launch_lock``), upload to copy-back: the serving
    batcher's threads replay CUDA graphs on the same stream, and none of
    their work may interleave with this (a capture at warmup must not see
    a copy either)."""
    from ..models.bert import resolve_device
    from ..models.graphs import launch_lock

    device = resolve_device(device)
    if vote_mask is None:
        vote_mask = np.ones(np.shape(weights), dtype=np.float32)
    with launch_lock(device), torch.inference_mode():
        cw, conf = consensus.tally_batch(
            np.asarray(votes, np.float32), np.asarray(weights, np.float32),
            np.asarray(vote_mask, np.float32), device=device,
        )
        return cw.cpu().numpy(), conf.cpu().numpy()
