"""The offline training subsystem: the lane feed, the weight learner and
the model trainers.

The port's copy of ``llm_weighted_consensus_tpu/train/__init__.py``.  The
serving engine closes its own loop here: serve -> ledger -> learn ->
serve with better weights:

* ``train.feed``  streams ``LEDGER_DIR`` shards and archive records into
  the batcher's offline priority class (``priority="offline"``);
* ``train.fit``   fits per-judge consensus weights as one batched torch
  optimization over every ledger record, emitting the versioned table
  ``weights/live.py`` hot-swaps via ``PUT /v1/weights``;
* ``__main__``    ``python -m llm_weighted_consensus_tpu_torch.train
  rescore|fit``, the operator CLI for both.

This module keeps the lower-level model trainers:

* ``contrastive_train_step``: bge-style InfoNCE over (query, positive)
  pairs with in-batch negatives (CLS pooling, an f32 ``q . p^T / 0.05``,
  cross-entropy against ``arange(b)``), the recipe behind the embedding
  tables of training-table weights;
* ``reward_train_step``: the pairwise Bradley-Terry loss
  ``softplus(-(r_chosen - r_rejected))`` on (chosen, rejected) pairs for
  the DeBERTa reward model.

Each step takes a model built by ``models.bert.trainable`` (f32
parameters that require grad, train mode) and a ``make_optimizer`` AdamW,
runs one forward and backward on the model's device (the card unless the
model was built on the CPU), the encoder with ``attention_impl="plain"``
(BERT) or ``plain=True`` (DeBERTa): the attention's, LayerNorm's and
GELU's plain versions in torch ops (in f32 the reference's trainers'
einsum attention computes the same), and returns the loss.
No hand-written kernel runs: the reference's trainers differentiate through
XLA ops, since its Pallas kernels define no VJP, and the port's kernels
define no backward.  The matmuls are f32 with TF32 off (torch's default
for matmuls; the steps refuse to run with it on) and no autocast, so a
step on the card matches one on the CPU to f32 rounding.

Both steps also run over a dp x tp mesh (``mesh=``, a
``parallel.mesh.Mesh``), the reference's GSPMD step written out: the
batch's rows split over dp, each dp row's encoder tensor-parallel over
its tp shards by the rule table (``parallel.sharding.MeshModel`` with
``trainable=True``: every shard tensor a differentiable slice of the
master parameter, so the backward pass sums every dp replica's gradient
into the master's ``.grad`` once, and one AdamW step updates it).  The
row-split layers add their bias once after the tp reduce, in the forward
and so in the backward.  InfoNCE's in-batch negatives span the global
batch: each dp row's queries meet every positive, all-gathered across dp
(``collectives.all_gather``) before the logits, and the shards' summed
cross-entropies (``psum``) divide by the global batch; a per-shard loss
would be another function.  The collectives are torch ops with autograd.

Checkpoints are the port's own files (``torch.save`` of a dict with a
``schema``): ``save_checkpoint`` keeps the parameters (the serving
artifact), ``save_train_state`` the parameters, the optimizer's moments
and the step, so a resumed run continues with the uninterrupted run's
losses.  An Orbax checkpoint (the reference's, a directory) is refused
by name.
"""

from __future__ import annotations

__all__ = [
    "make_optimizer",
    "contrastive_loss",
    "contrastive_train_step",
    "reward_pairwise_loss",
    "reward_train_step",
    "save_checkpoint",
    "load_checkpoint",
    "save_train_state",
    "load_train_state",
]

import io
import os

import torch
from torch import nn

from ..models import bert, deberta
from ..utils.io import atomic_write

CHECKPOINT_SCHEMA = "lwc.torch.checkpoint.v1"
TRAIN_STATE_SCHEMA = "lwc.torch.train_state.v1"


def make_optimizer(model, lr: float = 1e-4, weight_decay: float = 0.01):
    """AdamW over every parameter of ``model`` (a module or an iterable of
    parameters) with optax ``adamw``'s defaults: betas (0.9, 0.999), eps
    1e-8, decoupled decay on every parameter (optax's adamw is unmasked
    here too)."""
    params = model.parameters() if isinstance(model, nn.Module) else model
    return torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay,
    )


def _check_trainable(model, what: str) -> None:
    if not model.training or not any(
        p.requires_grad for p in model.parameters()
    ):
        raise ValueError(
            f"{what} needs a model built by models.bert.trainable (f32, "
            "gradients on, train mode)"
        )


def _check_tf32(device: torch.device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the trainers run f32 matmuls without TF32; set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )


def _on(model, *arrays) -> list:
    device = next(model.parameters()).device
    return [torch.as_tensor(a).to(device) for a in arrays]


def _placed(model, mesh, rules):
    """``model``'s differentiable placement on ``mesh`` (module doc)."""
    from ..parallel.sharding import shard_by_rules

    return shard_by_rules(model, mesh, rules, trainable=True)


def _dp_rows(mesh, batch: int, what: str) -> int:
    dp = mesh.shape["dp"]
    if batch % dp:
        raise ValueError(
            f"{what}: batch {batch} does not divide by dp={dp} (the "
            "batch's rows split over dp)"
        )
    return batch // dp


def _mesh_mean(parts: list, batch: int) -> torch.Tensor:
    """The shards' partial sums ``psum``-ed across dp, over the global
    batch."""
    from ..parallel.collectives import psum

    return psum(parts)[0] / batch


# ---------------------------------------------------------------------------
# Contrastive encoder training (InfoNCE, in-batch negatives)
# ---------------------------------------------------------------------------


def contrastive_loss(model, q_ids, q_mask, p_ids, p_mask,
                     temperature: float = 0.05, mesh=None) -> torch.Tensor:
    """Mean InfoNCE loss of a batch of (query, positive) pairs, every
    other positive a negative: CLS-pooled, L2-normalized embeddings,
    f32 logits ``q . p^T / temperature``, cross-entropy against the
    diagonal.  ``mesh``: over a dp x tp mesh (module doc)."""
    if mesh is not None:
        return _contrastive_loss_mesh(model, q_ids, q_mask, p_ids, p_mask,
                                      temperature, mesh)
    q_ids, q_mask, p_ids, p_mask = _on(model, q_ids, q_mask, p_ids, p_mask)
    q = bert.embed(model, q_ids, q_mask, pooling="cls",
                   attention_impl="plain")
    p = bert.embed(model, p_ids, p_mask, pooling="cls",
                   attention_impl="plain")
    logits = (q.float() @ p.float().T) / temperature
    labels = torch.arange(q.shape[0], device=logits.device)
    return nn.functional.cross_entropy(logits, labels)


def _contrastive_loss_mesh(model, q_ids, q_mask, p_ids, p_mask,
                           temperature, mesh) -> torch.Tensor:
    from ..parallel.collectives import all_gather
    from ..parallel.sharding import bert_partition_rules

    q_ids, q_mask, p_ids, p_mask = _on(model, q_ids, q_mask, p_ids, p_mask)
    batch = q_ids.shape[0]
    per = _dp_rows(mesh, batch, "contrastive_loss")
    placed = _placed(model, mesh, bert_partition_rules())
    q = bert.embed_mesh_parts(placed, q_ids, q_mask, pooling="cls",
                              attention_impl="plain")
    p = bert.embed_mesh_parts(placed, p_ids, p_mask, pooling="cls",
                              attention_impl="plain")
    # every dp row's queries against the global batch's positives
    p_all = all_gather(p)
    parts = []
    for d, (q_d, p_d) in enumerate(zip(q, p_all)):
        logits = (q_d.float() @ p_d.float().T) / temperature
        labels = d * per + torch.arange(per, device=logits.device)
        parts.append(nn.functional.cross_entropy(logits, labels,
                                                 reduction="sum"))
    return _mesh_mean(parts, batch)


def contrastive_train_step(model, optimizer, q_ids, q_mask, p_ids, p_mask,
                           temperature: float = 0.05,
                           mesh=None) -> torch.Tensor:
    """One InfoNCE step on ``model`` in place; returns the step's loss
    (before the update), detached.  ``mesh``: the step over a dp x tp
    mesh (module doc); the batch divides by dp."""
    _check_trainable(model, "contrastive_train_step")
    _check_tf32(next(model.parameters()).device)
    loss = contrastive_loss(model, q_ids, q_mask, p_ids, p_mask, temperature,
                            mesh=mesh)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


# ---------------------------------------------------------------------------
# Reward-model pairwise training
# ---------------------------------------------------------------------------


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def reward_pairwise_loss(model, chosen_ids, chosen_mask, rejected_ids,
                         rejected_mask, mesh=None) -> torch.Tensor:
    """Bradley-Terry: the mean of ``-log sigmoid(r_chosen - r_rejected)``
    (``softplus(-(r_c - r_r))``, as ``jax.nn.softplus`` computes it).
    ``mesh``: over a dp x tp mesh (module doc)."""
    chosen_ids, chosen_mask, rejected_ids, rejected_mask = _on(
        model, chosen_ids, chosen_mask, rejected_ids, rejected_mask)
    if mesh is not None:
        return _reward_loss_mesh(model, chosen_ids, chosen_mask,
                                 rejected_ids, rejected_mask, mesh)
    r_chosen = deberta.reward(model, chosen_ids, chosen_mask, plain=True)
    r_rejected = deberta.reward(model, rejected_ids, rejected_mask,
                                plain=True)
    return torch.mean(_softplus(-(r_chosen - r_rejected)))


def _reward_loss_mesh(model, chosen_ids, chosen_mask, rejected_ids,
                      rejected_mask, mesh) -> torch.Tensor:
    from ..parallel.sharding import deberta_partition_rules

    batch = chosen_ids.shape[0]
    _dp_rows(mesh, batch, "reward_pairwise_loss")
    placed = _placed(model, mesh, deberta_partition_rules())

    def body(shard, part, tp):
        hidden = yield from deberta.encode_steps(
            shard, part["ids"], part["mask"], tp=tp, plain=True)
        return (yield from deberta._head_steps(
            shard, hidden[:, 0, :].float(), tp=tp))

    r_chosen = bert._mesh_encode(
        placed, {"ids": chosen_ids, "mask": chosen_mask}, body)
    r_rejected = bert._mesh_encode(
        placed, {"ids": rejected_ids, "mask": rejected_mask}, body)
    parts = [torch.sum(_softplus(-(c - r)))
             for c, r in zip(r_chosen, r_rejected)]
    return _mesh_mean(parts, batch)


def reward_train_step(model, optimizer, chosen_ids, chosen_mask,
                      rejected_ids, rejected_mask, mesh=None) -> torch.Tensor:
    """One Bradley-Terry step on ``model`` in place; returns the step's
    loss (before the update), detached.  ``mesh``: the step over a dp x
    tp mesh (module doc); the batch divides by dp."""
    _check_trainable(model, "reward_train_step")
    _check_tf32(next(model.parameters()).device)
    loss = reward_pairwise_loss(model, chosen_ids, chosen_mask,
                                rejected_ids, rejected_mask, mesh=mesh)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------


def _refuse_orbax(path: str) -> None:
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is a directory: an Orbax checkpoint (the JAX "
            "package's format) is not read by the port; carry its "
            "parameters over with models.convert and save_checkpoint"
        )


def _save(path: str, doc: dict) -> None:
    buf = io.BytesIO()
    torch.save(doc, buf)
    payload = buf.getvalue()
    atomic_write(path, lambda f: f.write(payload))


def _load(path: str, schema: str) -> dict:
    _refuse_orbax(path)
    doc = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(doc, dict) or doc.get("schema") != schema:
        raise ValueError(f"{path!r} is not a {schema} file")
    return doc


def _params(model) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_checkpoint(path: str, model) -> None:
    """The model's parameters (the serving artifact) as one file."""
    _refuse_orbax(path)
    _save(path, {"schema": CHECKPOINT_SCHEMA, "params": _params(model)})


def load_checkpoint(path: str, like=None):
    """The parameters ``save_checkpoint`` wrote: loaded into ``like`` (a
    module of the same structure, returned) or, without one, as a
    {name: CPU tensor} state dict."""
    params = _load(path, CHECKPOINT_SCHEMA)["params"]
    if like is None:
        return params
    like.load_state_dict(params)
    return like


def save_train_state(path: str, model, optimizer, step: int) -> None:
    """The full training state (parameters, the optimizer's moments and
    counts, the step), so an interrupted run resumes with the same
    losses; a parameters-only checkpoint would reset the moments."""
    _refuse_orbax(path)
    _save(path, {
        "schema": TRAIN_STATE_SCHEMA,
        "params": _params(model),
        "opt_state": optimizer.state_dict(),
        "step": int(step),
    })


def load_train_state(path: str, like_model, like_optimizer) -> tuple:
    """Restore ``save_train_state``'s file into ``like_model`` and
    ``like_optimizer`` (built as the original run built them: the same
    structure, any values) -> ``(model, optimizer, step)``."""
    doc = _load(path, TRAIN_STATE_SCHEMA)
    like_model.load_state_dict(doc["params"])
    like_optimizer.load_state_dict(doc["opt_state"])
    return like_model, like_optimizer, int(doc["step"])
