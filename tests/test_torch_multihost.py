"""The port's process group on the CPU: ``parallel/dist.py`` and
``parallel/multihost_smoke.py``, the counterpart of
``tests/test_multihost.py``.

``run_group`` spawns real processes that rendezvous over a localhost TCP
store and form a gloo group: 2 and 3 processes tally with dp across
them; 2 x 2 also runs the tp-split encoder inside each process and
gathers the dp blocks across, and the recorded collectives show that tp
never crossed the process boundary.  Each group is bounded by its own
timeout (``RUN_S``), so a hung rendezvous fails the test instead of
eating the suite's limit.
"""

import pytest
import torch

from llm_weighted_consensus_tpu.parallel import multihost_smoke as ref_smoke
from llm_weighted_consensus_tpu_torch.parallel import dist, multihost_smoke
from llm_weighted_consensus_tpu_torch.parallel.multihost_smoke import (
    collective_boundary_report,
    expected_confidence,
    run_group,
)

RUN_S = 100.0  # each group's bound, well inside the suite's limit


def _group(num, dpp):
    return run_group(num, devices_per_proc=dpp, device="cpu", timeout=RUN_S,
                     attempts=1)


def test_two_process_group_tallies_and_agrees():
    results = _group(2, 1)
    assert [r["process_id"] for r in results] == [0, 1]
    for r in results:
        assert r["backend"] == "gloo" and r["host_copies"] is False
        assert r["confidence"] == pytest.approx(expected_confidence(),
                                                abs=1e-6)
        assert r["crossing_group_sizes"] == [2]
        assert r["within_process_groups"] == 0


def test_three_process_group_widens_the_dp_proof():
    results = _group(3, 1)
    assert len(results) == 3
    assert all(r["crossing_group_sizes"] == [3] for r in results)


def test_two_process_four_device_mesh_runs_tp_inside_dp_across():
    results = _group(2, 2)
    for r in results:
        assert r["global_devices"] == 4 and r["mesh_shape"] == {"dp": 2,
                                                                "tp": 2}
        assert r["encoder_max_err_vs_unsharded"] <= 1e-5
        assert r["within_process_groups"] >= 1
        assert r["within_process_group_sizes"] == [2]
        assert r["crossing_group_sizes"] == [2]
        assert r["tp_devices"] == ["cpu", "cpu"]


def test_expected_confidence_is_the_references():
    assert multihost_smoke.VOTES == ref_smoke.VOTES
    assert multihost_smoke.WEIGHTS == ref_smoke.WEIGHTS
    assert expected_confidence() == pytest.approx(
        ref_smoke.expected_confidence(), abs=1e-12)
    assert sum(expected_confidence()) == pytest.approx(1.0)


def test_the_boundary_report_classifies_the_groups():
    notes = [
        {"op": "psum", "group_size": 2, "crosses_process": False},
        {"op": "all_reduce", "group_size": 3, "crosses_process": True},
        {"op": "all_gather", "group_size": 3, "crosses_process": True},
    ]
    assert collective_boundary_report(notes, 3) == {
        "within_process_groups": 1, "within_process_group_sizes": [2],
        "crossing_groups": 2, "crossing_group_sizes": [3],
    }


def test_the_flag_off_is_a_no_op_and_the_env_is_required():
    assert dist.maybe_initialize_distributed({}) is False
    assert dist.multihost_requested({"MULTIHOST": "1"})
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
        dist.maybe_initialize_distributed({"MULTIHOST": "1",
                                           "NUM_PROCESSES": "2",
                                           "PROCESS_ID": "0"})


def test_the_backend_is_a_function_of_the_placement(monkeypatch):
    cpu, cuda = torch.device("cpu"), lambda i: torch.device("cuda", i)
    assert dist.placement(2, 1, "cpu") == ((cpu,), "gloo", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert dist.placement(2, 1, "cuda") == ((cuda(1),), "nccl", False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    # NCCL refuses two ranks on one card: gloo over host copies
    assert dist.placement(2, 1, "cuda") == ((cuda(0),), "gloo", True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="is_available"):
        dist.placement(2, 0, "cuda")


@pytest.mark.parametrize("cards,want", [
    # a card for every shard of every process: process i takes
    # [i * dpp, (i + 1) * dpp)
    (4, [((0, 1), "nccl", False), ((2, 3), "nccl", False)]),
    (8, [((0, 1), "nccl", False), ((2, 3), "nccl", False)]),
    # a card per process: its shards share it
    (2, [((0, 0), "nccl", False), ((1, 1), "nccl", False)]),
    (3, [((0, 0), "nccl", False), ((1, 1), "nccl", False)]),
    # one card: every shard on it, gloo over host copies
    (1, [((0, 0), "gloo", True), ((0, 0), "gloo", True)]),
])
def test_the_placement_takes_distinct_cards_for_tp_where_there_are_enough(
        monkeypatch, cards, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for pid, (idx, backend, host) in enumerate(want):
        devices, got_backend, got_host = dist.placement(2, pid, "cuda", 2)
        assert devices == tuple(torch.device("cuda", i) for i in idx)
        assert (got_backend, got_host) == (backend, host)
    assert dist.placement(3, 2, "cpu", 2) == (
        (torch.device("cpu"),) * 2, "gloo", False)
