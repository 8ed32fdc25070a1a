"""The consensus reduction and the mesh's collectives, written out as
cross-device work.

Counterpart of ``llm_weighted_consensus_tpu/parallel/collectives.py``.
The reference runs a ``shard_map`` body once per shard and lets XLA move
the data (``all_gather``, ``psum``, ``pmax``, ``ppermute`` over ICI).
One process drives every shard here, so a body is a loop over the
shards, each holding its tensors on its own device, and each collective
is explicit copies and sums:

* ``all_gather``: every shard's tensor copied to each device and
  concatenated in shard order;
* ``psum`` / ``pmax``: on each device, the shards' tensors summed (or
  maximised) in shard order, so every shard gets the same bits;
* ``ppermute``: each shard's tensor moved one shard along the ring.

Work for a device is computed once per distinct device, so shards that
share a card share the result, and the copies are no-ops.  Launches are
asynchronous per device: shards on distinct cards overlap.

``run_lockstep`` drives per-shard generator bodies (``models/bert.py``'s
tensor-parallel and ring layers) through their collectives.
``recording()`` notes every collective of more than one shard, with its
group size, so a run can show which groups it formed
(``parallel/multihost_smoke.py``; ``parallel/dist.py`` notes the ones
that cross the process group); a collective ``run_lockstep`` forms also
notes its mesh ``axis`` and its ``members``' coordinates (the mesh
audit's collective plan, ``analysis/mesh_audit.py`` JXA008).

The collectives are torch ops (``to``, ``add``, ``maximum``, ``cat``), so
they carry autograd: the trainers' mesh steps differentiate through them
(``train/__init__.py``).

``sharded_cosine_vote`` and ``sharded_tally`` are the reference's two
reductions.  The reference runs no Pallas kernel in them (its einsums and
softmax are XLA ops), so they are torch ops here; the vote's Gram matrix
is f32 at full precision (the package turns TF32 off).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from .mesh import Mesh

_local = threading.local()


@contextlib.contextmanager
def recording():
    """Note, on this thread, every collective of more than one shard as
    ``{"op", "group_size", "crosses_process"}``; yields the list."""
    notes: list = []
    saved = getattr(_local, "notes", None)
    _local.notes = notes
    try:
        yield notes
    finally:
        _local.notes = saved


def note(op: str, group_size: int, crosses_process: bool = False) -> None:
    notes = getattr(_local, "notes", None)
    if notes is not None and group_size > 1:
        entry = {"op": op, "group_size": int(group_size),
                 "crosses_process": bool(crosses_process)}
        group = getattr(_local, "group", None)
        if group is not None:
            entry.update(group)
        notes.append(entry)


def _per_device(devices: list, make) -> list:
    """``make(device)`` once per distinct device, one entry per shard."""
    made: dict = {}
    out = []
    for device in devices:
        if device not in made:
            made[device] = make(device)
        out.append(made[device])
    return out


def _devices(parts: list, devices: Optional[list]) -> list:
    return list(devices) if devices is not None else [p.device for p in parts]


def all_gather(parts: list, devices: Optional[list] = None,
               dim: int = 0) -> list:
    """Every shard gets the shards' tensors concatenated along ``dim``."""
    note("all_gather", len(parts))
    return _per_device(
        _devices(parts, devices),
        lambda d: torch.cat([p.to(d) for p in parts], dim),
    )


def _reduce(op: str, parts: list, devices: Optional[list], fn) -> list:
    note(op, len(parts))

    def on(device):
        acc = parts[0].to(device)
        for p in parts[1:]:
            acc = fn(acc, p.to(device))
        return acc

    return _per_device(_devices(parts, devices), on)


def psum(parts: list, devices: Optional[list] = None) -> list:
    """Every shard gets the shards' sum, taken in shard order."""
    return _reduce("psum", parts, devices, torch.add)


def pmax(parts: list, devices: Optional[list] = None) -> list:
    """Every shard gets the shards' elementwise maximum."""
    return _reduce("pmax", parts, devices, torch.maximum)


def ppermute(parts: list, shift: int = 1) -> list:
    """Shard i's tensor moves to shard (i + shift) mod n."""
    n = len(parts)
    note("ppermute", n)
    out = [None] * n
    for i, part in enumerate(parts):
        j = (i + shift) % n
        out[j] = part.to(parts[j].device)
    return out


def _ring(payloads: list) -> list:
    from .ring import ring_attention

    q, k, v, bias = (list(t) for t in zip(*(p[:4] for p in payloads)))
    return ring_attention(q, k, v, bias, payloads[0][4])


_OPS = {"psum": psum, "pmax": pmax, "ring": _ring}


def _current(device):
    """``device`` current while a shard's code runs: a hand-written
    kernel launches in the current device's context (torch ops guard
    their own)."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def run_lockstep(bodies: list, coords: list, sizes: dict,
                 devices: Optional[list] = None) -> list:
    """Run per-shard generator ``bodies`` to their return values.  A body
    yields ``(op, axis, payload)`` at each collective: ``"psum"`` or
    ``"pmax"`` over a tensor, or ``"ring"`` over ``(q, k, v, bias,
    scale)`` (ring attention); the group is the shards whose ``coords``
    (a dict per body: ``{"dp": d, "tp": t, "sp": s}``) agree on every axis
    but ``axis``, ordered along it, and each body resumes with its own
    share of the result.  ``sizes`` gives each axis's size; a group of
    another size (a body that yielded another op, or returned early)
    raises.  ``devices`` (one per body) is made current while its body
    runs."""
    devices = devices or [None] * len(bodies)
    sends = [None] * len(bodies)
    results = [None] * len(bodies)
    live = list(range(len(bodies)))
    while live:
        asks = {}
        for i in live:
            try:
                with _current(devices[i]):
                    asks[i] = bodies[i].send(sends[i])
            except StopIteration as stop:
                results[i] = stop.value
        live = [i for i in live if i in asks]
        groups: dict = {}
        for i in live:
            op, axis, _ = asks[i]
            rest = tuple(sorted(
                (k, v) for k, v in coords[i].items() if k != axis))
            groups.setdefault((op, axis, rest), []).append(i)
        for (op, axis, _), members in groups.items():
            if len(members) != sizes.get(axis, 1):
                raise RuntimeError(
                    f"collective {op!r} over {axis!r} gathered "
                    f"{len(members)} shards of {sizes.get(axis, 1)}"
                )
            members.sort(key=lambda i: coords[i].get(axis, 0))
            _local.group = {"axis": axis,
                            "members": [dict(coords[i]) for i in members]}
            try:
                out = _OPS[op]([asks[i][2] for i in members])
            finally:
                _local.group = None
            for i, value in zip(members, out):
                sends[i] = value
    return results


# -- the consensus reductions -------------------------------------------------


def _dp_devices(mesh: Mesh) -> list:
    return [mesh.device(dp=i) for i in range(mesh.shape["dp"])]


def _split_rows(x: torch.Tensor, devices: list) -> list:
    """Pad ``x``'s rows to a multiple of len(devices) and give each
    device its block."""
    dp = len(devices)
    pad = (-x.shape[0]) % dp
    if pad:
        x = torch.nn.functional.pad(x, (0, 0) * (x.ndim - 1) + (0, pad))
    return [part.to(d) for part, d in zip(x.chunk(dp), devices)]


def sharded_cosine_vote(
    embeddings,
    mesh: Mesh,
    temperature=0.05,
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """embeddings[N, D] (a tensor, padded here to a dp multiple, or a list
    of the dp shards' row blocks) -> confidence[N_valid] f32 on the first
    dp shard's device.

    The reference's distributed vote: each shard normalises its rows in
    f32, all-gathers every shard's normalised rows, takes its block of
    the similarity matrix in f32 at full precision, the mean off-diagonal
    similarity over the ``n_valid`` real columns, and the softmax with a
    global max (``pmax``) and a global sum (``psum``).  Rows at and past
    ``n_valid`` are masked out of the mean and the softmax and sliced
    off."""
    devices = _dp_devices(mesh)
    if isinstance(embeddings, (list, tuple)):
        parts = [p.to(d) for p, d in zip(embeddings, devices)]
        rows = sum(p.shape[0] for p in parts)
    else:
        rows = embeddings.shape[0]
        parts = _split_rows(embeddings, devices)
    n = rows if n_valid is None else int(n_valid)
    local_n = parts[0].shape[0]
    total = local_n * len(parts)
    x_n = []
    for p in parts:
        x32 = p.float()
        norm = torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True))
        x_n.append(x32 / torch.clamp(norm, min=1e-12))
    x_all = all_gather(x_n)
    logits, row_valid = [], []
    for i, (x, gathered) in enumerate(zip(x_n, x_all)):
        dev = x.device
        sims = torch.matmul(x, gathered.t())  # [local_n, total] f32
        row_ids = i * local_n + torch.arange(local_n, device=dev)
        col_ids = torch.arange(total, device=dev)
        valid_col = (col_ids < n)[None, :] & (
            col_ids[None, :] != row_ids[:, None])
        mean_sim = torch.sum(
            torch.where(valid_col, sims, torch.zeros((), device=dev)),
            dim=-1) / max(n - 1, 1)
        temp = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
        valid = row_ids < n
        logits.append(torch.where(
            valid, mean_sim / temp,
            torch.full((), float("-inf"), device=dev)))
        row_valid.append(valid)
    global_max = pmax([torch.max(lg) for lg in logits])
    e = [
        torch.where(v, torch.exp(lg - m), torch.zeros((), device=lg.device))
        for lg, v, m in zip(logits, row_valid, global_max)
    ]
    denom = psum([torch.sum(x) for x in e])
    out = [x / d for x, d in zip(e, denom)]
    return torch.cat([o.to(devices[0]) for o in out])[:n]


def sharded_tally(votes, weights, mesh: Mesh) -> torch.Tensor:
    """votes[M, N] and weights[M] (tensors or arrays), judges split over
    dp -> confidence[N] f32 on the first dp shard's device: each shard
    tallies its judges (f32, full precision), one ``psum`` adds the
    shards' tallies, and the sum is normalised (0 where it is 0)."""
    devices = _dp_devices(mesh)
    votes = torch.as_tensor(votes, dtype=torch.float32, device=devices[0])
    weights = torch.as_tensor(weights, dtype=torch.float32,
                              device=devices[0])
    v_parts = _split_rows(votes, devices)
    w_parts = _split_rows(weights[:, None], devices)
    local = [torch.matmul(w.t(), v)[0] for v, w in zip(v_parts, w_parts)]
    choice = psum(local)[0]
    total = torch.sum(choice)
    return torch.where(total > 0, choice / total, torch.zeros_like(choice))
