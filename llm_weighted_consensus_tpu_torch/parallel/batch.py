"""Archive batch re-scoring (BASELINE config 4), on one device or over a
mesh.

Counterpart of ``llm_weighted_consensus_tpu/parallel/batch.py``:
re-scoring thousands of archived score requests is one batched tally.
With a mesh the batch shards over EVERY mesh axis (the per-request
tallies are independent, so any mesh shape flattens into one batch
axis), padded to a multiple of the mesh's size: each shard tallies its
block on its own device, and the blocks come back in order.
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
    mesh=None,
    device=None,
):
    """votes[B, M, N], weights[B, M] -> (choice_weight[B, N],
    confidence[B, N]) as f32 numpy arrays.

    Without a mesh the inputs are uploaded once and tallied on
    ``device`` (the card unless the caller passes ``"cpu"``); with one,
    on every shard's device.  Either way under each device's launch lock
    (``models.graphs.launch_lock``), upload to copy-back: the serving
    batcher's threads replay CUDA graphs on the same stream, and none of
    their work may interleave with this (a capture at warmup must not see
    a copy either)."""
    from ..models.bert import resolve_device
    from ..models.graphs import launch_lock

    votes = np.asarray(votes, np.float32)
    weights = np.asarray(weights, np.float32)
    if vote_mask is None:
        vote_mask = np.ones(np.shape(weights), dtype=np.float32)
    vote_mask = np.asarray(vote_mask, np.float32)
    if mesh is None:
        shards = [(resolve_device(device), slice(None))]
    else:
        b = votes.shape[0]
        pad = (-b) % mesh.size
        if pad:
            votes = np.pad(votes, ((0, pad), (0, 0), (0, 0)))
            weights = np.pad(weights, ((0, pad), (0, 0)))
            vote_mask = np.pad(vote_mask, ((0, pad), (0, 0)))
        per = votes.shape[0] // mesh.size
        shards = [(d, slice(i * per, (i + 1) * per))
                  for i, d in enumerate(mesh.flat())]
    cws, confs = [], []
    for dev, rows in shards:
        with launch_lock(dev), torch.inference_mode():
            cw, conf = consensus.tally_batch(
                votes[rows], weights[rows], vote_mask[rows], device=dev)
            cws.append(cw.cpu().numpy())
            confs.append(conf.cpu().numpy())
    b = np.shape(weights)[0] if mesh is None else votes.shape[0] - pad
    return (np.concatenate(cws)[:b], np.concatenate(confs)[:b])
