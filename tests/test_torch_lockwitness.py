"""The port's ``LockWitness`` (``analysis/witness.py``) held against the
reference's, and ``LOCK_WITNESS=1`` on a CPU server.

* **Witness parity.** Both witnesses run the same scripted acquisition
  sequences, on threads held in step by barriers: the declared order,
  inversions against a declared and an observed edge, an inversion
  through a declared transitive chain, RLock re-entry, plain-lock
  re-entry, a condition wait and its hand-off across threads, and the
  shape gate as one logical lock.  Their snapshots and summary lines are
  equal (the reference's own cases, ``tests/test_lockwitness.py``, pin
  the values).
* **The served witness.** A test-tiny server built with ``LOCK_WITNESS=1``
  takes a ``/consensus`` burst, an ``/embeddings`` request, a score
  request, a multichat stream, a ``PUT /v1/weights`` swap and an offline
  drive: 0 violations and 0 undeclared edges, every wrapped primitive
  acquired, and the answers equal those of the same server with the knob
  unset.  Unset, nothing is wrapped and ``/metrics`` has no
  ``lock_witness`` section.
"""

import json
import random
import threading
import urllib.error
import urllib.request

import pytest

from llm_weighted_consensus_tpu.analysis import witness as ref_witness
from llm_weighted_consensus_tpu.resilience.meshfault import (
    _ShapeGate as RefGate,
)
from llm_weighted_consensus_tpu_torch.analysis import witness as port_witness
from llm_weighted_consensus_tpu_torch.resilience.meshfault import (
    _ShapeGate as PortGate,
)

SIDES = {"ref": (ref_witness.LockWitness, RefGate),
         "port": (port_witness.LockWitness, PortGate)}


def _model(kinds, order=(), order_runtime=()):
    return {
        "locks": {k: {"kind": v, "guards": ()} for k, v in kinds.items()},
        "order": order,
        "order_runtime": order_runtime,
    }


def _threads(*steps):
    """Run each step on its own named thread, one after the other."""
    for i, step in enumerate(steps):
        t = threading.Thread(target=step, name=f"scripted-{i}")
        t.start()
        t.join(10)
        assert not t.is_alive()


def declared_order(Witness, Gate):
    w = Witness(_model({"A": "lock", "B": "lock"}, order=(("A", "B"),)))
    a = w.wrap_lock("A", threading.Lock())
    b = w.wrap_lock("B", threading.Lock())

    def nest():
        for _ in range(3):
            with a:
                with b:
                    pass

    _threads(nest, nest)
    return w


def inversion_against_declared(Witness, Gate):
    w = Witness(_model({"A": "lock", "B": "lock"}, order=(("A", "B"),)))
    a = w.wrap_lock("A", threading.Lock())
    b = w.wrap_lock("B", threading.Lock())

    def reverse():
        with b:
            with a:
                pass

    _threads(reverse)
    return w


def inversion_against_observed(Witness, Gate):
    """Two threads, the first walking A -> B, the second B -> A after a
    barrier: the second walk inverts the first's observed edge."""
    w = Witness(_model({"A": "lock", "B": "lock"}))
    a = w.wrap_lock("A", threading.Lock())
    b = w.wrap_lock("B", threading.Lock())
    first_done = threading.Barrier(2)

    def forward():
        with a:
            with b:
                pass
        first_done.wait(5)

    def backward():
        first_done.wait(5)
        with b:
            with a:
                pass

    ts = [threading.Thread(target=fn, name=f"scripted-{i}")
          for i, fn in enumerate((forward, backward))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    return w


def inversion_through_chain(Witness, Gate):
    w = Witness(_model({"A": "lock", "B": "lock", "C": "lock"},
                       order=(("A", "B"), ("B", "C"))))
    a = w.wrap_lock("A", threading.Lock())
    c = w.wrap_lock("C", threading.Lock())

    def close_the_cycle():
        with c:
            with a:
                pass

    _threads(close_the_cycle)
    return w


def rlock_reentry(Witness, Gate):
    w = Witness(_model({"R": "rlock"}))
    r = w.wrap_lock("R", threading.RLock())

    def reenter():
        with r:
            with r:
                pass

    _threads(reenter)
    return w


def plain_lock_reentry(Witness, Gate):
    # declared a non-reentrant Lock; an RLock underneath keeps the test
    # itself from deadlocking (the witness judges by the declared kind)
    w = Witness(_model({"L": "lock"}))
    lock = w.wrap_lock("L", threading.RLock())

    def reenter():
        with lock:
            with lock:
                pass

    _threads(reenter)
    return w


def condition_wait_and_handoff(Witness, Gate):
    """A waiter sleeps in ``wait_for`` holding C then takes L; the
    notifier takes C (only possible if the proxy released it) then L:
    neither walk is an edge C -> C, and the order is C -> L both times."""
    w = Witness(_model({"C": "condition", "L": "lock"}, order=(("C", "L"),)))
    cond = w.wrap_lock("C", threading.Condition())
    lock = w.wrap_lock("L", threading.Lock())
    state = {"ready": False}
    sleeping = threading.Barrier(2)

    def waiter():
        with cond:
            sleeping.wait(5)
            cond.wait_for(lambda: state["ready"], timeout=5.0)
            with lock:
                pass

    def notifier():
        sleeping.wait(5)
        with cond:
            state["ready"] = True
            cond.notify_all()
            with lock:
                pass

    ts = [threading.Thread(target=fn, name=f"scripted-{i}")
          for i, fn in enumerate((waiter, notifier))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
        assert not t.is_alive()
    return w


def gate_as_one_lock(Witness, Gate):
    w = Witness(_model({"G": "condition", "L": "lock"}, order=(("G", "L"),)))
    gate = w.wrap_gate(Gate(), key="G")
    lock = w.wrap_lock("L", threading.Lock())

    def shared_then_exclusive():
        with gate.shared():
            with lock:
                pass
        with gate.exclusive():
            pass

    _threads(shared_then_exclusive)
    return w


SCENARIOS = {fn.__name__: fn for fn in (
    declared_order, inversion_against_declared, inversion_against_observed,
    inversion_through_chain, rlock_reentry, plain_lock_reentry,
    condition_wait_and_handoff, gate_as_one_lock)}

WANT = {
    "declared_order": ("lock witness: 12 acquisitions, 1 edge(s), "
                       "0 undeclared, 0 violation(s)"),
    "inversion_against_declared": ("lock witness: 2 acquisitions, "
                                   "1 edge(s), 1 undeclared, "
                                   "1 violation(s)"),
    "inversion_against_observed": ("lock witness: 4 acquisitions, "
                                   "2 edge(s), 2 undeclared, "
                                   "1 violation(s)"),
    "inversion_through_chain": ("lock witness: 2 acquisitions, 1 edge(s), "
                                "1 undeclared, 1 violation(s)"),
    "rlock_reentry": ("lock witness: 2 acquisitions, 0 edge(s), "
                      "0 undeclared, 0 violation(s)"),
    "plain_lock_reentry": ("lock witness: 2 acquisitions, 0 edge(s), "
                           "0 undeclared, 1 violation(s)"),
    "condition_wait_and_handoff": ("lock witness: 5 acquisitions, "
                                   "1 edge(s), 0 undeclared, "
                                   "0 violation(s)"),
    "gate_as_one_lock": ("lock witness: 3 acquisitions, 1 edge(s), "
                         "0 undeclared, 0 violation(s)"),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_witness_snapshots_equal_the_references(name):
    got = SCENARIOS[name](*SIDES["port"])
    want = SCENARIOS[name](*SIDES["ref"])
    assert got.snapshot() == want.snapshot()
    assert got.summary_line() == want.summary_line() == WANT[name]


def test_counts_add_up_to_the_acquisitions():
    w = condition_wait_and_handoff(*SIDES["port"])
    counts = w.counts()
    assert counts == {"C": 3, "L": 2}
    assert sum(counts.values()) == w.snapshot()["acquisitions"]


def test_condition_wait_releases_the_held_entry():
    w = port_witness.LockWitness(_model({"C": "condition"}))
    cond = w.wrap_lock("C", threading.Condition())
    held = []

    def pred():
        held.append(list(w._stack()))
        return True

    with cond:
        assert w._stack() == ["C"]
        cond.wait_for(pred, timeout=1.0)
        assert w._stack() == ["C"]
        cond.wait(0.001)
        assert w._stack() == ["C"]
    assert w._stack() == []
    assert held and all("C" not in h for h in held)


def test_the_default_model_is_the_ports_registry():
    from llm_weighted_consensus_tpu_torch.analysis.concurrency_model import (
        CONCURRENCY_MODEL,
    )

    w = port_witness.LockWitness()
    assert w._kinds == {k: e["kind"]
                        for k, e in CONCURRENCY_MODEL["locks"].items()}
    assert ("_ShapeGate._cond", "launch_lock.lock") in w._declared
    assert ("AdmissionController._lock", "MemGuard._lock") in w._declared


# -- LOCK_WITNESS=1 on a CPU server --------------------------------------------

PANEL = {"llms": [{"model": "judge-a",
                   "weight": {"type": "static", "weight": 2}}]}
CANDIDATES = [f"candidate {i}: the answer is {i % 3} apples" for i in range(6)]


def _http(port, path, body=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _serve(env, drive):
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_embedder,
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    config = ServeConfig.from_env(env)
    emb = build_embedder(env, device="cpu")
    srv = build_server(emb, None, config, device="cpu").start()
    try:
        warm_up(srv, config)
        return drive(srv)
    finally:
        srv.close()


def _drive(srv):
    port, out = srv.port, {}
    burst = [CANDIDATES[: 2 + i % 4] for i in range(8)]
    results = [None] * len(burst)

    def one(i):
        results[i] = _http(port, "/consensus", {"input": burst[i]})

    ts = [threading.Thread(target=one, args=(i,)) for i in range(len(burst))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    out["burst"] = [(s, json.loads(b)["confidence"]) for s, b in results]
    s, b = _http(port, "/embeddings", {"model": "test-tiny",
                                       "input": CANDIDATES[:3]})
    out["embeddings"] = (s, [d["embedding"] for d in json.loads(b)["data"]])
    # one judge: the fake provider's one random draw per request is
    # seeded, and so is the judge's ballot
    srv.score_client.rng_factory = lambda: random.Random(11)
    random.seed(7)
    s, b = _http(port, "/score/completions", {
        "messages": [{"role": "user", "content": "which is best?"}],
        "model": PANEL, "choices": CANDIDATES[:3]})
    score = json.loads(b)
    out["score"] = (s, [c["confidence"] for c in score["choices"]])
    s, b = _http(port, "/multichat/completions", {
        "messages": [{"role": "user", "content": "say something"}],
        "model": {"llms": [{"model": f"gen-{i}"} for i in range(3)]},
        "stream": True, "consensus": True})
    frames = [blk[6:] for blk in b.decode().split("\n\n")
              if blk.startswith("data: ")]
    out["stream"] = (s, frames[-1], sum(
        '"multichat.consensus"' in f for f in frames))
    s, b = _http(port, "/v1/weights", {"weights": {"judge-a": 3.0}},
                 method="PUT")
    out["swap"] = (s, json.loads(b).get("version"))
    s, b = _http(port, "/v1/train/rescore",
                 {"groups": 6, "n": 4, "seed": 0, "inflight": 2})
    drive = json.loads(b)
    out["offline"] = (s, drive["groups"], drive["items"], drive["errors"])
    metrics = json.loads(_http(port, "/metrics")[1])
    return out, metrics


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from llm_weighted_consensus_tpu_torch.serve.fake_upstream import (
        FakeUpstream,
    )

    fake = FakeUpstream()
    base = {
        "EMBEDDER_MODEL": "test-tiny", "LWC_ALLOW_RANDOM_PARAMS": "1",
        "EMBEDDER_MAX_TOKENS": "32", "WARMUP": "4x16", "BATCH_WINDOW_MS": "5",
        "OPENAI_API_BASE": fake.url, "OPENAI_API_KEY": "k",
        "MESH_ENABLED": "1", "MESH_FAULT_ENABLED": "1",
        "DEVICE_WATCHDOG_MILLIS": "5000", "WEIGHTS_ENABLED": "1",
        "OFFLINE_ENABLED": "1", "TRACE_SAMPLE_RATE": "1.0",
        "LEDGER_RING": "64", "SCORE_CACHE_TTL": "60",
    }
    try:
        off = _serve(base, _drive)
        on = _serve({**base, "LOCK_WITNESS": "1"}, _drive)
    finally:
        fake.close()
    return off, on


def test_served_witness_is_clean(served):
    _, (_, metrics) = served
    snap = metrics["lock_witness"]
    assert snap["violations"] == []
    assert snap["undeclared"] == []
    assert snap["acquisitions"] == sum(snap["locks"].values()) > 0


def test_every_wrapped_primitive_was_acquired(served):
    _, (_, metrics) = served
    locks = metrics["lock_witness"]["locks"]
    for key in ("launch_lock.lock", "StagingPool._lock", "DeviceBatcher._cond",
                "DeviceBatcher._embed_lock", "_ShapeGate._cond",
                "MeshFaultManager._lock", "DeviceWatchdog._lock",
                "AdmissionController._lock", "MemGuard._lock",
                "Metrics._lock", "PhaseAggregator._lock",
                "QualityAggregator._lock", "TraceSink._lock",
                "OutcomeLedger._lock", "LiveWeightStore._lock"):
        assert locks.get(key, 0) > 0, (key, locks)


def test_answers_equal_with_the_knob_unset(served):
    (off, off_metrics), (on, _) = served
    assert "lock_witness" not in off_metrics
    assert on == off
    assert all(s == 200 for s, _ in on["burst"])
    assert on["score"][0] == on["stream"][0] == on["swap"][0] == 200
    assert on["stream"][1] == "[DONE]" and on["stream"][2] >= 1
    assert on["offline"] == (200, 6, 24, 0)


def test_the_knob_is_read_as_the_references():
    from llm_weighted_consensus_tpu.serve.config import Config
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    for raw in ("1", "true", "0", "", "no"):
        assert (ServeConfig.from_env({"LOCK_WITNESS": raw}).lock_witness
                == Config.from_env({"LOCK_WITNESS": raw}).lock_witness)
    assert ServeConfig.from_env({}).lock_witness is False
