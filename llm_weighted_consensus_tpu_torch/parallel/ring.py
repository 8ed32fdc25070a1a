"""Ring attention: sequence parallelism over an ``sp`` mesh axis.

Counterpart of ``llm_weighted_consensus_tpu/parallel/ring.py``
(blockwise ring attention, Liu et al.): the sequence axis is split over
the sp shards, each shard keeps its q block, and the k/v/bias blocks
rotate around the ring (``collectives.ppermute``, ``sp - 1`` times) while
an online-softmax accumulator in f32 (running max, running denominator,
weighted sum) folds each visiting block in.  After ``sp`` steps every q
block has attended to the whole sequence and no shard ever held more
than a [b, nh, s/sp, s/sp] score tile: at bert-long-8k's s = 8192 over
sp = 4, 268 MB of f32 logits per shard and step, where the whole
[16, 8192, 8192] matrix would be 4.3 GB.

The reference computes this with einsums (no Pallas kernel), so it is
torch ops here: f32 matmuls at full precision and elementwise f32.  One
process drives every shard (``collectives.run_lockstep``): each step
runs the sp shards' blocks in turn, asynchronously per device.

``ring_encode`` runs the BERT forward with the sequence split over sp:
each shard embeds its slice with positions offset by its start
(``bert.encode_steps(..., position_offset=...)``) and its layers'
attention yields to the ring (``attention_impl="ring"``); params are
whole on every shard (the reference replicates them).  ``ring_embed``
pools the result, ``_ring_embed_and_vote`` adds the dp-sharded consensus
vote, and ``shard_embedder_sp`` wires the legacy ``MESH_SP`` hook into a
``TorchEmbedder``.
"""

from __future__ import annotations

import torch

from .collectives import ppermute, run_lockstep, sharded_cosine_vote
from .mesh import Mesh

NEG_INF = -1e9


def ring_attention(q: list, k: list, v: list, bias: list,
                   scale: float) -> list:
    """Per sp shard, in ring order: q/k/v[b, s_loc, nh, hd] and the local
    keys' additive padding bias[b, s_loc] (0 real, -1e9 pad) -> the
    shard's ctx[b, s_loc, nh, hd] in q's dtype, equal to the full
    softmax(QK^T * scale + bias) V over the global sequence."""
    sp = len(q)
    qf = [x.float().permute(0, 2, 1, 3) for x in q]  # [b, nh, sq, hd]
    acc, denom, run_max = [], [], []
    for x in qf:
        b, nh, s_loc, hd = x.shape
        acc.append(torch.zeros((b, nh, s_loc, hd), dtype=torch.float32,
                               device=x.device))
        denom.append(torch.zeros((b, nh, s_loc), dtype=torch.float32,
                                 device=x.device))
        run_max.append(torch.full((b, nh, s_loc), NEG_INF,
                                  dtype=torch.float32, device=x.device))
    k_cur, v_cur, bias_cur = list(k), list(v), list(bias)
    for step in range(sp):
        for i in range(sp):
            kf = k_cur[i].float().permute(0, 2, 3, 1)  # [b, nh, hd, sk]
            vf = v_cur[i].float().permute(0, 2, 1, 3)  # [b, nh, sk, hd]
            logits = torch.matmul(qf[i], kf) * scale
            logits = logits + bias_cur[i].float()[:, None, None, :]
            new_max = torch.maximum(run_max[i], torch.amax(logits, dim=-1))
            correction = torch.exp(run_max[i] - new_max)
            p = torch.exp(logits - new_max[..., None])
            acc[i] = acc[i] * correction[..., None] + torch.matmul(p, vf)
            denom[i] = denom[i] * correction + torch.sum(p, dim=-1)
            run_max[i] = new_max
        if step < sp - 1:
            k_cur = ppermute(k_cur)
            v_cur = ppermute(v_cur)
            bias_cur = ppermute(bias_cur)
    return [
        (a / d[..., None]).permute(0, 2, 1, 3).to(x.dtype)
        for a, d, x in zip(acc, denom, q)
    ]


def _placed(model, mesh: Mesh):
    """``model`` as a ``MeshModel`` whose every shard is whole."""
    from .sharding import MeshModel, bert_partition_rules
    from ..models.quant import is_quantized

    if isinstance(model, MeshModel):
        return model
    rules = bert_partition_rules(quantized=is_quantized(model))
    return MeshModel(model, mesh, rules, tp=False)


def _check_ring(config, s: int, sp: int) -> None:
    from ..models.configs import usable_positions

    if s % sp != 0:
        raise ValueError(f"sequence {s} must divide sp={sp}")
    if s > usable_positions(config):
        raise ValueError(
            f"sequence {s} exceeds the position table's usable window "
            f"({usable_positions(config)}); long contexts need a config "
            "with a matching position table"
        )


def ring_encode(model, input_ids, attention_mask, mesh: Mesh,
                sp_axis: str = "sp", dp_axis=None) -> list:
    """BERT forward with the sequence split over ``sp_axis``: ids/mask
    [b, s] (s a multiple of sp) -> per dp row, the hidden states [b/dp,
    s, h] on that row's first sp shard.  ``model`` is a ``BertEncoder`` or
    a ``MeshModel`` (whole params on every shard); ``dp_axis`` also
    splits the batch over that axis."""
    from ..models import bert

    placed = _placed(model, mesh)
    b, s = input_ids.shape
    sp = mesh.shape[sp_axis]
    _check_ring(placed.config, s, sp)
    dp = mesh.shape[dp_axis] if dp_axis else 1
    if b % dp:
        raise ValueError(f"batch {b} does not divide by dp={dp}")
    rows, s_loc = b // dp, s // sp
    bodies, coords, devices = [], [], []
    for d in range(dp):
        for j in range(sp):
            device = mesh.device(**{sp_axis: j, **({dp_axis: d} if dp_axis
                                                   else {})})
            r = slice(d * rows, (d + 1) * rows)
            c = slice(j * s_loc, (j + 1) * s_loc)
            bodies.append(bert.encode_steps(
                placed.full(device), input_ids[r, c].to(device),
                attention_mask[r, c].to(device), attention_impl="ring",
                position_offset=j * s_loc,
            ))
            coords.append({"dp": d, "sp": j})
            devices.append(device)
    hidden = run_lockstep(bodies, coords, {"sp": sp}, devices)
    out = []
    for d in range(dp):
        parts = hidden[d * sp:(d + 1) * sp]
        out.append(torch.cat([h.to(parts[0].device) for h in parts], dim=1))
    return out


def ring_embed(model, input_ids, attention_mask, mesh: Mesh,
               sp_axis: str = "sp", dp_axis=None, pooling: str = "cls",
               normalize: bool = True) -> torch.Tensor:
    """The sequence-parallel twin of ``bert.embed``: pooled vectors [b, h]
    f32 on the mesh's first device."""
    from ..models import bert

    hidden = ring_encode(model, input_ids, attention_mask, mesh, sp_axis,
                         dp_axis)
    rows = input_ids.shape[0] // len(hidden)
    pooled = [
        bert.pool(h, attention_mask[d * rows:(d + 1) * rows].to(h.device),
                  pooling, normalize)
        for d, h in enumerate(hidden)
    ]
    first = mesh.device()
    return torch.cat([p.to(first) for p in pooled])


def _ring_embed_and_vote(model, input_ids, attention_mask, temperature,
                         n: int, mesh: Mesh, sp_axis: str = "sp",
                         dp_axis=None, pooling: str = "cls") -> torch.Tensor:
    """The ring twin of the mesh embed-and-vote: the sequence-split
    forward, pooling, and the dp-sharded consensus vote over the first
    ``n`` rows -> confidence[n]."""
    emb = ring_embed(model, input_ids, attention_mask, mesh, sp_axis,
                     dp_axis, pooling, True)
    return sharded_cosine_vote(emb, mesh, temperature, n_valid=n)


def shard_embedder_sp(embedder, mesh: Mesh, sp_axis: str = "sp",
                      dp_axis=None) -> None:
    """The legacy ``MESH_SP`` hook: the embedder's embedding forward is
    ``ring_embed`` over ``mesh`` (``embed_override``), sequences padded
    to an sp multiple, the token window capped so that the padding never
    passes the position table, batches padded to a dp multiple.  The
    consensus paths keep their own dispatch (self-consistency candidates
    are short by contract); this serves ``/embeddings``."""
    import numpy as np

    from ..models.configs import usable_positions

    sp = mesh.shape[sp_axis]
    embedder.batch_multiple = mesh.shape[dp_axis] if dp_axis else 1
    embedder.max_tokens = min(
        embedder.max_tokens, (usable_positions(embedder.config) // sp) * sp)
    placed = _placed(embedder.model, mesh)

    def forward(ids, mask):
        pad_s = (-ids.shape[1]) % sp
        if pad_s:  # pads are masked keys: attention ignores them
            ids = np.pad(ids, ((0, 0), (0, pad_s)))
            mask = np.pad(mask, ((0, 0), (0, pad_s)))
        with torch.inference_mode():
            first = mesh.device()
            return ring_embed(
                placed, torch.from_numpy(np.ascontiguousarray(ids)).to(first),
                torch.from_numpy(np.ascontiguousarray(mask)).to(first),
                mesh, sp_axis=sp_axis, dp_axis=dp_axis,
                pooling=embedder.pooling, normalize=True,
            ).cpu().numpy()

    embedder.embed_override = forward
    embedder.sp_mesh = mesh
