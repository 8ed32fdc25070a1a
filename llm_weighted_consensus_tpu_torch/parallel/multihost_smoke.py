"""Multi-process smoke: actually form the process group.

Counterpart of ``llm_weighted_consensus_tpu/parallel/multihost_smoke.py``.
``parallel.dist.maybe_initialize_distributed`` is the multi-host entry
point; this module proves it forms a real group without a cluster: N
processes rendezvous at a localhost TCP store and run the consensus
tally with dp across the processes (each tallies its block of judges,
one cross-process sum adds them), the path that crosses hosts on a real
deployment.

With ``devices_per_proc > 1`` each process also runs the DESIGN.md
placement: tp inside the process (``devices_per_proc`` tp shards of the
test-tiny encoder on the process's devices, ``dist.placement``:
distinct cards where the machine has a card for each shard of each
process, else the process's one card; ``bert.embed_mesh``) and dp
across processes (each process embeds its block of the batch, one
cross-process all-gather assembles it).  Every process checks the
result against an unsharded forward of the whole batch.  The reference
reads the compiled HLO's replica groups to show where the collectives
ran; the port records its own collectives (``collectives.recording``:
each in-process collective with its group size, each one over the
process group marked as crossing it), and the gate is the same: tp
never crosses the process boundary, and only dp-sized groups do.

Two entry points:

* ``python -m llm_weighted_consensus_tpu_torch.parallel.multihost_smoke``
  is one worker (env: ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
  ``PROCESS_ID``, ``DEVICES_PER_PROC``, ``DIST_DEVICE`` = cpu | cuda, set
  by the launcher).  It prints ``MULTIHOST_OK {json}`` on success;
* ``run_group(num_processes, devices_per_proc, device=...)`` spawns the
  workers, collects and cross-checks their outputs.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

# deterministic fixture: M=4 judges, N=3 candidates
VOTES = [
    [1.0, 0.0, 0.0],
    [0.0, 1.0, 0.0],
    [0.25, 0.5, 0.25],
    [0.0, 0.0, 1.0],
]
WEIGHTS = [2.0, 1.0, 1.0, 0.5]


def expected_confidence():
    total = sum(WEIGHTS)
    per = [
        sum(VOTES[m][n] * WEIGHTS[m] for m in range(len(WEIGHTS)))
        for n in range(len(VOTES[0]))
    ]
    return [p / total for p in per]


def collective_boundary_report(notes: list, num: int) -> dict:
    """Classify the recorded collectives: inside one process (tp) or
    across the group (dp)."""
    within = [n for n in notes if not n["crosses_process"]]
    crossing = [n for n in notes if n["crosses_process"]]
    return {
        "within_process_groups": len(within),
        "within_process_group_sizes": sorted(
            {n["group_size"] for n in within}),
        "crossing_groups": len(crossing),
        "crossing_group_sizes": sorted({n["group_size"] for n in crossing}),
    }


def worker_main() -> None:
    """One process of the group (see module doc)."""
    import numpy as np
    import torch

    from .collectives import recording
    from .dist import maybe_initialize_distributed

    dpp = int(os.environ.get("DEVICES_PER_PROC", "1"))
    group = maybe_initialize_distributed(
        device=os.environ.get("DIST_DEVICE", "cpu"), devices_per_proc=dpp)
    assert group, "MULTIHOST env not set?"
    num = int(os.environ["NUM_PROCESSES"])
    assert group.world_size == num, (
        f"process group has {group.world_size} processes, want {num}")
    # replicating the WHOLE vote table scales numerator and denominator of
    # the normalised tally equally: expected_confidence() holds at any size
    reps = 1
    while (len(VOTES) * reps) % num:
        reps += 1
    votes = np.array(VOTES * reps, np.float32)
    weights = np.array(WEIGHTS * reps, np.float32)
    per = votes.shape[0] // num
    mine = slice(group.rank * per, (group.rank + 1) * per)
    with recording() as notes:
        t0 = time.perf_counter()
        v = torch.from_numpy(votes[mine]).to(group.device)
        w = torch.from_numpy(weights[mine]).to(group.device)
        local = torch.matmul(w[None], v)[0]  # this dp shard's judges
        choice = group.all_reduce(local)
        total = torch.sum(choice)
        conf = torch.where(total > 0, choice / total,
                           torch.zeros_like(choice)).cpu()
        tally_ms = (time.perf_counter() - t0) * 1e3
        out = {
            "process_id": group.rank,
            "num_processes": num,
            "global_devices": num * dpp,
            "mesh_shape": {"dp": num, "tp": dpp},
            "device": str(group.device),
            "tp_devices": [str(d) for d in group.devices],
            "backend": group.backend,
            "host_copies": group.host_copies,
            "confidence": conf.tolist(),
            "tally_ms": tally_ms,
        }
        if dpp > 1:
            out.update(_encoder_phase(group, num, dpp))
    out.update(collective_boundary_report(notes, num))
    group.close()
    print("MULTIHOST_OK " + json.dumps(out), flush=True)


def _encoder_phase(group, num: int, dpp: int) -> dict:
    """The tp-split encoder forward inside this process on its block of
    the batch, the blocks gathered across the group, checked against an
    unsharded forward of the whole batch."""
    import numpy as np
    import torch

    from ..models import bert
    from ..models.configs import TEST_TINY
    from .mesh import make_mesh
    from .sharding import shard_bert_params

    config = TEST_TINY
    device = group.device
    model = bert.init_params(config, seed=0, dtype=torch.float32,
                             device=device)
    rng = np.random.default_rng(7)
    batch = 2 * num
    ids_np = rng.integers(3, config.vocab_size, size=(batch, 16)).astype(
        np.int32)
    ids = torch.from_numpy(ids_np).to(device)
    mask = torch.ones((batch, 16), dtype=torch.int32, device=device)
    with torch.inference_mode():
        ref = bert.embed(model, ids, mask, pooling="cls").cpu()
        # the process's tp group: dpp shards on its own devices (distinct
        # cards where the machine has enough, ``dist.placement``)
        placed = shard_bert_params(
            model, make_mesh(dp=1, tp=dpp, devices=list(group.devices)))
        rows = slice(2 * group.rank, 2 * group.rank + 2)
        t0 = time.perf_counter()
        local = bert.embed_mesh(placed, ids[rows], mask[rows],
                                pooling="cls")
        emb = group.all_gather(local).cpu()
        forward_ms = (time.perf_counter() - t0) * 1e3
    return {
        "encoder_max_err_vs_unsharded": float(torch.max(
            torch.abs(emb - ref))),
        "encoder_checksum": float(np.sum(emb.numpy(), dtype=np.float64)),
        "encoder_forward_ms": forward_ms,
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(
    num_processes: int = 2,
    devices_per_proc: int = 1,
    device: str = "cpu",
    timeout: float = 300.0,
    attempts: int = 2,
) -> list:
    """Spawn the worker group on ``device`` ("cpu" or "cuda"); return the
    per-process result dicts.  Raises on any worker failure or
    disagreement: the gate of the smoke.  The store's port is probed and
    released before the workers bind it, so one retry with a fresh port
    absorbs the rare steal.  Each worker is killed past ``timeout``
    seconds, so a hung rendezvous fails.

    With ``devices_per_proc > 1`` the gate also asserts that every
    process agrees on the encoder output and matches the unsharded
    forward, that at least one collective ran inside a process (the tp
    reduces) and at least one across it, and that every crossing group
    has exactly ``num_processes`` members: only dp crosses."""
    last: Exception = RuntimeError("unreachable")
    for _ in range(attempts):
        try:
            return _run_group_once(num_processes, devices_per_proc, device,
                                   timeout)
        except RuntimeError as exc:
            last = exc
    raise last


def _run_group_once(num_processes: int, devices_per_proc: int,
                    device: str, timeout: float) -> list:
    coordinator = f"127.0.0.1:{_free_port()}"
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env.update(
            MULTIHOST="1",
            COORDINATOR_ADDRESS=coordinator,
            NUM_PROCESSES=str(num_processes),
            PROCESS_ID=str(pid),
            DEVICES_PER_PROC=str(devices_per_proc),
            DIST_DEVICE=device,
            PYTHONPATH=repo_root + os.pathsep + os.environ.get(
                "PYTHONPATH", ""),
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "llm_weighted_consensus_tpu_torch.parallel.multihost_smoke"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    results, failures = [], []
    deadline = time.monotonic() + timeout
    for pid, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failures.append(f"process {pid} timed out:\n{out[-2000:]}")
            continue
        marker = [line for line in out.splitlines()
                  if line.startswith("MULTIHOST_OK ")]
        if proc.returncode != 0 or not marker:
            failures.append(
                f"process {pid} rc={proc.returncode}:\n{out[-2000:]}")
            continue
        results.append(json.loads(marker[0][len("MULTIHOST_OK "):]))
    for proc in procs:  # stop every process this call started
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if failures:
        raise RuntimeError("multi-process smoke failed:\n"
                           + "\n---\n".join(failures))
    results.sort(key=lambda r: r["process_id"])
    _check_group(results, num_processes, devices_per_proc)
    return results


def _check_group(results: list, num: int, dpp: int) -> None:
    confs = [r["confidence"] for r in results]
    first = confs[0]
    for other in confs[1:]:
        if any(abs(a - b) > 1e-6 for a, b in zip(first, other)):
            raise RuntimeError(f"processes disagree on the tally: {confs}")
    exp = expected_confidence()
    if any(abs(a - b) > 1e-5 for a, b in zip(first, exp)):
        raise RuntimeError(f"tally {first} != expected {exp}")
    for r in results:
        if r["num_processes"] != num or r["global_devices"] != num * dpp:
            raise RuntimeError(f"group shape wrong: {r}")
        if r["crossing_groups"] < 1:
            raise RuntimeError(f"no process-crossing collective found: {r}")
        bad = [s for s in r["crossing_group_sizes"] if s != num]
        if bad:
            raise RuntimeError(
                "collective groups other than dp cross the process "
                f"boundary: sizes {bad}")
    if dpp > 1:
        sums = {round(r["encoder_checksum"], 4) for r in results}
        if len(sums) != 1:
            raise RuntimeError(
                f"processes disagree on the encoder output: {sums}")
        for r in results:
            if r["encoder_max_err_vs_unsharded"] > 2e-4:
                raise RuntimeError(
                    "sharded encoder diverges from the unsharded "
                    f"forward: {r['encoder_max_err_vs_unsharded']}")
            if r["within_process_groups"] < 1:
                raise RuntimeError(
                    "no within-process collective found: the tp reduces "
                    f"are missing: {r}")
            if r["within_process_group_sizes"] != [dpp]:
                raise RuntimeError(
                    "in-process collectives of another size than tp: "
                    f"{r['within_process_group_sizes']}")


if __name__ == "__main__":
    worker_main()
