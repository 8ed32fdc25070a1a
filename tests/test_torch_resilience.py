"""The port's judge-side resilience against the JAX package's, on the
same inputs, clocks and scripted transports.

* The pure cores, step by step on one injected clock: ``CircuitBreaker``
  and ``BreakerRegistry`` (trip at the threshold, the volume floor,
  half-open probes, ``release_probe``), ``RetryBudget``, ``Deadline``,
  ``LatencyTracker`` and ``HedgePolicy`` (static, quantile, cold
  suppression), ``QuorumTracker`` (seeded Decimal panels, ``explain``),
  ``FaultPlan`` and ``JudgeBiasPlan`` (parse, the same seed's sequence,
  scripts and their exhaustion, the errors).
* The port's ``DefaultChatClient`` with a policy: a breaker rejects
  locally and recovers, 4xx answers and an expired deadline do not count
  as failures, a cancelled half-open probe hands its slot back, a hedge
  spends the shared retry budget (and is denied when it is dry), a
  cancelled hedge race leaves no task behind, and a hedge loser's socket
  is closed on a loopback server.
* The port's ``ScoreClient`` against the JAX ``ScoreClient`` over one
  scripted transport each: a quorum-degraded panel, a hedge that wins and
  is tallied once, a deadline-degraded panel, an all-failed panel, a
  ``JUDGE_BIAS_PLAN`` panel, and a seeded ``FAULT_PLAN`` panel whose
  (judge, fault) sequence must be the reference's.  Every frame equal
  byte for byte once the response id and ``created`` are masked, and the
  ``resilience`` counters equal.  With no policy the wire has no
  ``degraded`` field.
* Through the port's server (``build_server``): a quorum-degraded score
  request is never cached under ``SCORE_CACHE_TTL`` (the repeat fans out
  again) and its cancelled straggler's connection is closed; with the
  knobs set the ``resilience`` section appears and
  ``RESILIENCE_DEADLINE_MILLIS`` is the default deadline.
"""

import asyncio
import json
import random
import select
import socket
import threading
import time
from decimal import Decimal
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from llm_weighted_consensus_tpu import archive as ref_archive
from llm_weighted_consensus_tpu import registry as ref_registry
from llm_weighted_consensus_tpu import resilience as ref_res
from llm_weighted_consensus_tpu.ballot import PrefixTree, branch_limit
from llm_weighted_consensus_tpu.clients import chat as ref_chat
from llm_weighted_consensus_tpu.clients import score as ref_score
from llm_weighted_consensus_tpu.resilience import breaker as ref_breaker
from llm_weighted_consensus_tpu.types import score_request as ref_req
from llm_weighted_consensus_tpu.utils import jsonutil as ref_json
from llm_weighted_consensus_tpu_torch import archive as port_archive
from llm_weighted_consensus_tpu_torch import errors as port_errors
from llm_weighted_consensus_tpu_torch import registry as port_registry
from llm_weighted_consensus_tpu_torch import resilience as port_res
from llm_weighted_consensus_tpu_torch.clients import chat as port_chat
from llm_weighted_consensus_tpu_torch.clients import score as port_score
from llm_weighted_consensus_tpu_torch.resilience import breaker as port_breaker
from llm_weighted_consensus_tpu_torch.types import score_request as port_req
from llm_weighted_consensus_tpu_torch.types.chat_request import (
    ChatCompletionCreateParams,
    UserMessage,
)
from llm_weighted_consensus_tpu_torch.utils import jsonutil as port_json

from fakes import FakeTransport, Script, chunk_obj
from test_torch_chat_client import PortFakeTransport

SEED = 42
TEXTS = ["answer alpha", "answer beta", "answer gamma"]
AB = [("https://a.example", "key-a"), ("https://b.example", "key-b")]

PKGS = {
    "ref": SimpleNamespace(
        res=ref_res, chat=ref_chat, score=ref_score, req=ref_req,
        registry=ref_registry, archive=ref_archive, json=ref_json,
        transport=FakeTransport, breaker=ref_breaker,
    ),
    "port": SimpleNamespace(
        res=port_res, chat=port_chat, score=port_score, req=port_req,
        registry=port_registry, archive=port_archive, json=port_json,
        transport=PortFakeTransport, breaker=port_breaker,
    ),
}


def go(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def fake_clock():
    t = {"now": 0.0}
    return t, (lambda: t["now"])


# -- the pure cores, held step by step against the reference ---------------------

# (op, arg) scripts over one breaker; "tick" advances the shared clock
BREAKER_SCRIPTS = {
    "trips_at_threshold": [("fail", None), ("ok", None), ("fail", None),
                           ("fail", None), ("fail", None), ("allow", None)],
    "volume_floor": [("fail", None), ("fail", None), ("allow", None)],
    "half_open_recovers": [("fail", None)] * 5 + [
        ("allow", None), ("tick", 4.0), ("allow", None), ("tick", 2.0),
        ("allow", None), ("allow", None), ("ok", None), ("allow", None)],
    "half_open_reopens": [("fail", None)] * 5 + [
        ("tick", 6.0), ("allow", None), ("fail", None), ("allow", None),
        ("tick", 6.0), ("allow", None)],
    "release_probe": [("fail", None)] * 5 + [
        ("tick", 6.0), ("allow", None), ("allow", None), ("release", None),
        ("allow", None), ("ok", None)],
    "window_slides": [("fail", None), ("ok", None)] * 12 + [
        ("fail", None)] * 3,
}


def drive_breaker(pkg, script, config):
    t, clock = fake_clock()
    b = PKGS[pkg].breaker.CircuitBreaker(
        PKGS[pkg].breaker.BreakerConfig(**config), clock=clock)
    trail = []
    for op, arg in script:
        if op == "tick":
            t["now"] += arg
            out = None
        elif op == "allow":
            out = b.allow()
        elif op == "ok":
            out = b.record_success()
        elif op == "fail":
            out = b.record_failure()
        else:
            out = b.release_probe()
        trail.append((op, out, b.state, b.describe(), b.snapshot()))
    return trail


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
@pytest.mark.parametrize("config", [
    {},
    {"threshold": 0.5, "window": 4, "min_samples": 2, "cooldown_ms": 5000,
     "half_open_probes": 2},
    {"threshold": 0.0},
])
def test_breaker_state_machine_matches_the_reference(name, config):
    script = BREAKER_SCRIPTS[name]
    assert drive_breaker("port", script, config) == \
        drive_breaker("ref", script, config)


def test_breaker_registry_keys_and_snapshot_match():
    out = {}
    for pkg in ("ref", "port"):
        _, clock = fake_clock()
        reg = PKGS[pkg].breaker.BreakerRegistry(
            PKGS[pkg].breaker.BreakerConfig(min_samples=1, threshold=1.0),
            clock=clock)
        reg.get("https://b.example", "m1").record_failure()
        reg.get("https://a.example", "m2").record_success()
        out[pkg] = (reg.key("https://a.example", "m"), reg.snapshot())
    assert out["port"] == out["ref"]
    assert list(out["port"][1]) == ["https://a.example|m2",
                                    "https://b.example|m1"]


def test_retry_budget_and_deadline_match():
    for pkg in ("ref", "port"):
        res = PKGS[pkg].res
        budget = res.RetryBudget(2)
        token = budget.activate()
        try:
            assert res.current_retry_budget() is budget
            spent = [budget.try_acquire() for _ in range(4)]
        finally:
            res.RetryBudget.deactivate(token)
        assert res.current_retry_budget() is None
        assert spent == [True, True, False, False]
        assert (budget.spent, budget.denied) == (2, 2)
    for pkg in ("ref", "port"):
        res = PKGS[pkg].res
        t, clock = fake_clock()
        d = res.Deadline(0.5, clock=clock)
        t["now"] = 0.2
        assert d.remaining() == pytest.approx(0.3)
        assert d.clamp(10.0) == pytest.approx(0.3)
        assert d.clamp(0.1) == 0.1
        assert not d.expired()
        t["now"] = 0.6
        assert d.expired() and d.remaining() == 0.0


def test_latency_tracker_and_hedge_policy_match():
    rng = random.Random(3)
    samples = [rng.uniform(1, 500) for _ in range(700)]
    out = {}
    for pkg in ("ref", "port"):
        res = PKGS[pkg].res
        tracker = res.LatencyTracker(capacity=64)
        qs = []
        for i, ms in enumerate(samples):
            tracker.record(ms)
            if i % 37 == 0:
                qs.append([tracker.quantile(q)
                           for q in (0.0, 0.5, 0.9, 0.95, 1.0, 1.5)])
        static = res.HedgePolicy(delay_ms=40.0)
        cold = res.HedgePolicy(quantile=0.95, min_samples=20)
        warmish = res.HedgePolicy(delay_ms=25.0, quantile=0.9, min_samples=5)
        trail = [static.delay_ms_effective(), cold.delay_ms_effective(),
                 warmish.delay_ms_effective()]
        for ms in samples[:30]:
            cold.observe(ms)
            warmish.observe(ms)
            trail.append((cold.delay_ms_effective(),
                          warmish.delay_ms_effective(), cold.explain()))
        out[pkg] = (qs, len(tracker), tracker.total, trail,
                    res.LatencyTracker().quantile(0.5), static.enabled,
                    res.HedgePolicy().enabled)
    assert out["port"] == out["ref"]
    assert out["port"][3][1] is None  # a cold quantile-only hedge is off


def quorum_trail(pkg, weights, events, n, fraction):
    q = PKGS[pkg].res.QuorumTracker(weights, n, fraction)
    trail = [(q.decided(), q.explain())]
    for kind, judge, vote in events:
        if kind == "vote":
            q.record_vote(judge, vote)
        else:
            q.record_error(judge)
        trail.append((q.decided(), q.explain(), q.leader(),
                      str(q.remaining_weight), q.settled(judge)))
    return trail


@pytest.mark.parametrize("seed", range(12))
def test_quorum_tracker_matches_on_seeded_panels(seed):
    rng = random.Random(seed)
    n = rng.randint(2, 5)
    judges = rng.randint(1, 7)
    weights = {j: Decimal(repr(rng.choice([0.5, 1.0, 2.0, 3.25, 0.1])))
               for j in range(judges)}
    events = []
    for j in rng.sample(range(judges), judges):
        if rng.random() < 0.2:
            events.append(("error", j, None))
        else:
            vote = [Decimal(0)] * n
            vote[rng.randrange(n)] = Decimal(1)
            if rng.random() < 0.3:  # a soft vote
                vote = [Decimal(1) / Decimal(n)] * n
            events.append(("vote", j, vote))
        if rng.random() < 0.2:  # a repeat is ignored
            events.append(events[-1])
    fraction = rng.choice([0.0, 0.25, 0.5, 1.0])
    assert quorum_trail("port", weights, events, n, fraction) == \
        quorum_trail("ref", weights, events, n, fraction)


FAULT_SPECS = [
    "seed=7,stall_first=0.35,stall_ms=20000",
    "seed=42,connect=0.1,5xx=0.1,stall_first=0.1,stall_ms=200",
    "seed=3,malformed=0.2,truncate=0.2,stall_mid=0.1,giant_line=0.1,"
    "flood_bytes=1024",
    "seed=9,newline_less_flood=0.25,oversized_unary=0.2,binary_garbage=0.2",
    "script=connect|ok||5xx|stall_first,stall_ms=5",
]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_plan_sequences_match(spec):
    out = {}
    for pkg in ("ref", "port"):
        plan = PKGS[pkg].res.FaultPlan.parse(spec)
        seq = [plan.next_fault() for _ in range(200)]
        out[pkg] = (seq, plan.snapshot(), plan.stall_ms, plan.flood_bytes,
                    plan.probabilities)
        again = PKGS[pkg].res.FaultPlan.parse(spec)
        assert [again.next_fault() for _ in range(200)] == seq
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("spec", [
    "seed=1,bogus=0.1", "nokey", "script=connect|melt", "seed=x",
])
def test_fault_plan_parse_errors_match(spec):
    with pytest.raises(ValueError) as want:
        ref_res.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        port_res.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", [
    "judge=2,after=3,flip=1.0,seed=7",
    "judge=0,uniform=0.4,invert=0.4,seed=11",
    "judge=1,script=flip|ok|invert|uniform",
])
def test_judge_bias_plan_perturbations_match(spec):
    rng = random.Random(5)
    votes = []
    for _ in range(40):
        v = [Decimal(0)] * 4
        v[rng.randrange(4)] = Decimal(1)
        votes.append((rng.randrange(3), v))
    out = {}
    for pkg in ("ref", "port"):
        plan = PKGS[pkg].res.JudgeBiasPlan.parse(spec)
        seq = [plan.perturb(j, list(v)) for j, v in votes]
        out[pkg] = ([[str(x) for x in v] for v in seq], plan.snapshot())
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("spec", ["judge=1,melt=1", "judge", "script=x"])
def test_judge_bias_plan_parse_errors_match(spec):
    with pytest.raises(ValueError) as want:
        ref_res.JudgeBiasPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        port_res.JudgeBiasPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_policy_snapshot_matches():
    out = {}
    for pkg in ("ref", "port"):
        res = PKGS[pkg].res
        _, clock = fake_clock()
        policy = res.ResiliencePolicy(
            breakers=res.BreakerRegistry(res.BreakerConfig(), clock=clock),
            hedge=res.HedgePolicy(quantile=0.9),
            retry_budget_tokens=3, quorum_fraction=0.5, deadline_ms=100.0)
        policy.breakers.get("https://a.example", "m").record_failure()
        policy.inc("hedge_launched")
        policy.inc("hedge_launched", 2)
        out[pkg] = policy.snapshot()
    assert out["port"] == out["ref"]
    assert out["port"]["hedge_delay_ms"] is None


# -- the chat client with a policy ------------------------------------------------


def chat_client(transport, bases, policy, **backoff):
    return port_chat.DefaultChatClient(
        transport, [port_chat.ApiBase(*ab) for ab in bases],
        backoff=port_chat.BackoffPolicy(**(backoff or {"max_elapsed_ms": 0})),
        resilience=policy)


def chat_params():
    return ChatCompletionCreateParams(
        messages=[UserMessage(content="hi")], model="fake-model")


async def stream_items(c):
    stream = await c.create_streaming(None, chat_params())
    return [item async for item in stream]


def test_breaker_rejects_then_recovers_through_the_client():
    t, clock = fake_clock()
    policy = port_res.ResiliencePolicy(breakers=port_res.BreakerRegistry(
        port_res.BreakerConfig(threshold=1.0, window=2, min_samples=2,
                               cooldown_ms=5000), clock=clock))
    transport = PortFakeTransport([
        Script(connect_error=port_errors.TransportError("refused")),
        Script(connect_error=port_errors.TransportError("refused")),
        Script([chunk_obj("recovered")]),
    ])
    c = chat_client(transport, AB[:1], policy)
    for _ in range(2):
        with pytest.raises(port_errors.TransportError):
            go(stream_items(c))
    # open: refused locally, the recovery script stays unconsumed
    with pytest.raises(port_errors.BreakerOpenError):
        go(stream_items(c))
    assert len(transport.requests) == 2
    assert policy.counters["breaker_rejected"] == 1
    key = "https://a.example|fake-model"
    assert policy.snapshot()["breakers"][key]["state"] == "open"
    t["now"] += 6.0
    items = go(stream_items(c))
    assert items[0].choices[0].delta.content == "recovered"
    assert policy.snapshot()["breakers"][key]["state"] == "closed"


@pytest.mark.parametrize("err", [
    ("TransportError", ("x",)), ("StreamTimeoutError", ()),
    ("BadStatusError", (503, "busy")), ("BadStatusError", (429, "rate")),
    ("BadStatusError", (404, "missing")), ("BadStatusError", (400, "bad")),
    ("DeadlineExceededError", ()), ("EmptyStreamError", ()),
    ("IngestCapError", ("sse_event", 1, 2)), ("DeserializationError", ("j",)),
])
def test_breaker_failure_classification_matches(err):
    from llm_weighted_consensus_tpu import errors as ref_errors

    name, args = err
    assert port_chat._breaker_failure(getattr(port_errors, name)(*args)) == \
        ref_chat._breaker_failure(getattr(ref_errors, name)(*args))


def half_open_policy(clock):
    return port_res.ResiliencePolicy(breakers=port_res.BreakerRegistry(
        port_res.BreakerConfig(threshold=1.0, window=2, min_samples=2,
                               cooldown_ms=1000, half_open_probes=1),
        clock=clock))


def test_cancelled_half_open_probe_releases_its_slot():
    t, clock = fake_clock()
    policy = half_open_policy(clock)
    transport = PortFakeTransport([
        Script(connect_error=port_errors.TransportError("refused")),
        Script(connect_error=port_errors.TransportError("refused")),
        Script([chunk_obj("probe stalls")], delays={0: 30.0}),
        Script([chunk_obj("recovered")]),
    ])
    c = chat_client(transport, AB[:1], policy)
    for _ in range(2):
        with pytest.raises(port_errors.TransportError):
            go(stream_items(c))
    t["now"] += 1.1  # the next attempt is the probe

    async def run():
        task = asyncio.ensure_future(stream_items(c))
        await asyncio.sleep(0.05)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return await stream_items(c)

    items = go(run())
    assert items[0].choices[0].delta.content == "recovered"
    assert policy.breakers.get("https://a.example", "fake-model").state == \
        port_breaker.CLOSED


def test_deadline_expiry_is_neutral_for_a_half_open_breaker():
    t, clock = fake_clock()
    policy = half_open_policy(clock)
    transport = PortFakeTransport([
        Script(connect_error=port_errors.TransportError("refused")),
        Script(connect_error=port_errors.TransportError("refused")),
        Script([chunk_obj("too late")], delays={0: 30.0}),
        Script([chunk_obj("real probe")]),
    ])
    c = chat_client(transport, AB[:1], policy)
    for _ in range(2):
        with pytest.raises(port_errors.TransportError):
            go(stream_items(c))
    t["now"] += 1.1
    breaker = policy.breakers.get("https://a.example", "fake-model")

    async def under_deadline():
        token = port_res.Deadline(0.05).activate()
        try:
            return await stream_items(c)
        finally:
            port_res.Deadline.deactivate(token)

    with pytest.raises(port_errors.DeadlineExceededError):
        go(under_deadline())
    assert breaker.state == port_breaker.HALF_OPEN
    assert go(stream_items(c))[0].choices[0].delta.content == "real probe"
    assert breaker.state == port_breaker.CLOSED


def with_budget(budget, coro_fn):
    async def run():
        token = budget.activate()
        try:
            return await coro_fn()
        finally:
            port_res.RetryBudget.deactivate(token)

    return run()


def test_retry_budget_stops_the_backoff_loop():
    budget = port_res.RetryBudget(1)
    transport = PortFakeTransport([
        Script(connect_error=port_errors.TransportError("refused"))
        for _ in range(8)])
    c = chat_client(transport, AB[:1], port_res.ResiliencePolicy(),
                    initial_interval_ms=1, max_interval_ms=1,
                    max_elapsed_ms=60000)
    with pytest.raises(port_errors.TransportError):
        go(with_budget(budget, lambda: stream_items(c)))
    assert len(transport.requests) == 2  # the first pass + one retry
    assert budget.denied == 1


def test_a_hedge_spends_the_retry_budget_and_is_denied_when_dry():
    policy = port_res.ResiliencePolicy(hedge=port_res.HedgePolicy(
        delay_ms=20.0))
    transport = PortFakeTransport([
        Script([chunk_obj("slow")], delays={0: 1.0}),
        Script([chunk_obj("backup wins")])])
    c = chat_client(transport, AB, policy)
    budget = port_res.RetryBudget(1)
    items = go(with_budget(budget, lambda: stream_items(c)))
    assert items[0].choices[0].delta.content == "backup wins"
    assert budget.spent == 1
    assert policy.counters == {"hedge_launched": 1, "hedge_won": 1}

    policy = port_res.ResiliencePolicy(hedge=port_res.HedgePolicy(
        delay_ms=20.0))
    transport = PortFakeTransport([
        Script([chunk_obj("slow but fine")], delays={0: 0.2})])
    c = chat_client(transport, AB, policy)
    budget = port_res.RetryBudget(1)
    assert budget.try_acquire()  # dry before the request
    items = go(with_budget(budget, lambda: stream_items(c)))
    assert items[0].choices[0].delta.content == "slow but fine"
    assert len(transport.requests) == 1
    assert policy.counters == {"hedge_denied": 1}


def test_a_cancelled_hedge_race_discards_both_attempts():
    policy = port_res.ResiliencePolicy(hedge=port_res.HedgePolicy(
        delay_ms=10.0))
    transport = PortFakeTransport([
        Script([chunk_obj("slow-a")], delays={0: 30.0}),
        Script([chunk_obj("slow-b")], delays={0: 30.0})])
    c = chat_client(transport, AB, policy)

    async def run():
        task = asyncio.ensure_future(stream_items(c))
        await asyncio.sleep(0.1)
        assert policy.counters["hedge_launched"] == 1
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return [p for p in asyncio.all_tasks()
                if p is not asyncio.current_task()]

    assert go(run()) == []


class LoopbackJudges:
    """A stdlib SSE upstream on loopback that counts open connections.
    A model named ``mute-*`` holds its response headers, and one named
    ``stall-*`` its first frame (the reference's ``stall_first``), until
    ``release`` is set or its client hangs up; the others answer at once
    with a vote for the candidate ``pick`` names (its key read from the
    ballot), or, for a plain chat request, one content chunk."""

    def __init__(self, pick="answer alpha") -> None:
        judges = self
        self.lock = threading.Lock()
        self.open = 0
        self.calls = []
        self.release = threading.Event()

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["content-length"])))
                model = body.get("model", "")
                with judges.lock:
                    judges.open += 1
                    judges.calls.append(model)
                try:
                    if model.startswith("mute-") and judges.held(self):
                        return
                    self.send_response(200)
                    self.send_header("content-type", "text/event-stream")
                    self.send_header("transfer-encoding", "chunked")
                    self.end_headers()
                    self.wfile.flush()
                    if model.startswith("stall-") and judges.held(self):
                        return
                    text = body["messages"][-1]["content"]
                    content = "hello"
                    if "Select the response:" in text:
                        ballot = json.loads(text.split(
                            "Select the response:\n\n", 1)[1].split(
                            "\n\nOutput", 1)[0])
                        key = next(k for k, v in ballot.items() if v == pick)
                        content = f"I select {key}"
                    frame = chunk_obj(content, model=model, finish="stop")
                    raw = (f"data: {json.dumps(frame)}\n\n"
                           "data: [DONE]\n\n").encode()
                    self.wfile.write(b"%x\r\n%s\r\n0\r\n\r\n" % (len(raw), raw))
                    self.wfile.flush()
                    # hold the connection until the client closes it
                    self.connection.settimeout(5.0)
                    try:
                        while self.connection.recv(1024):
                            pass
                    except OSError:
                        pass
                finally:
                    with judges.lock:
                        judges.open -= 1
                    self.close_connection = True

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 64

        self.httpd = Server(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/v1"

    def held(self, handler) -> bool:
        """Hold ``handler`` until ``release`` (False) or its client hangs
        up (True)."""
        while not self.release.is_set():
            ready, _, _ = select.select([handler.connection], [], [], 0.02)
            if ready and not handler.connection.recv(1, socket.MSG_PEEK):
                return True
        return False

    def wait_closed(self, timeout=2.0) -> int:
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            with self.lock:
                if self.open == 0:
                    return 0
            time.sleep(0.01)
        return self.open

    def close(self) -> None:
        self.release.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(5)


@pytest.mark.parametrize("slow", ["stall-a", "mute-a"])
def test_a_hedge_losers_socket_is_closed(slow):
    """The loser is cancelled mid-stream (``stall``) or before its
    response headers came (``mute``: inside ``StdlibTransport.post_sse``);
    either way its connection closes."""
    judges = LoopbackJudges()
    try:
        policy = port_res.ResiliencePolicy(hedge=port_res.HedgePolicy(
            delay_ms=30.0))
        c = port_chat.DefaultChatClient(
            port_chat.StdlibTransport(), [port_chat.ApiBase(judges.url, "k")],
            backoff=port_chat.BackoffPolicy(max_elapsed_ms=0),
            resilience=policy)
        params = ChatCompletionCreateParams(
            messages=[UserMessage(content="hi")], model=slow,
            models=["fast-b"])

        async def run():
            stream = await c.create_streaming(None, params)
            return [item async for item in stream]

        # the attempt matrix is [stall-a, fast-b]: the primary stalls,
        # the hedge on fast-b wins, and the primary is cancelled; the
        # stalled handler returns only when its client hangs up
        items = go(run())
        assert items[0].choices[0].delta.content == "hello"
        assert policy.counters == {"hedge_launched": 1, "hedge_won": 1}
        assert judges.wait_closed() == 0
        assert judges.calls == [slow, "fast-b"]
    finally:
        judges.close()


# -- the score client against the reference ---------------------------------------


def ballot_keys(n, top_logprobs=None):
    rng = random.Random(SEED)
    tree = PrefixTree.build(rng, n, branch_limit(top_logprobs))
    return {idx: key for key, idx in tree.key_indices(rng)}


KEYS = ballot_keys(3)


def judge_script(key, **kw):
    return Script([chunk_obj("I pick ", model="up-model"),
                   chunk_obj(f"{key} as best.", model="up-model",
                             finish="stop")], **kw)


def clone(s):
    return Script(list(s.events), status=s.status, body=s.body,
                  connect_error=s.connect_error, delays=dict(s.delays),
                  done=s.done)


def port_script(s):
    out = clone(s)
    if isinstance(s.connect_error, ref_chat.TransportError):
        out.connect_error = port_errors.TransportError(
            s.connect_error.error, s.connect_error.code)
    return out


def judge_order(judges):
    from llm_weighted_consensus_tpu.identity.model import ModelBase

    model = ModelBase.from_json_obj({"llms": judges}).into_model_validate()
    return [llm.base.model for llm in model.llms]


def body(judges, **kw):
    return {"messages": [{"role": "user", "content": "pick the best"}],
            "model": {"llms": judges}, "choices": TEXTS, **kw}


def masked(pkg, item) -> str:
    if isinstance(item, Exception):
        return f"error {item.status()} {item.message()}"
    obj = item.to_json_obj()
    obj["id"] = obj["id"].split("-")[0]
    obj["created"] = 0
    return PKGS[pkg].json.dumps(obj)


class Recording:
    """A transport decorator that notes each request's model, in the
    order the fan-out opens them, before the fault injector draws."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.models = []

    async def post_sse(self, url, headers, body):
        self.models.append(json.loads(body)["model"])
        return await self.inner.post_sse(url, headers, body)

    async def close(self):
        pass


def run_panel(pkg, req_body, scripts, policy=None, bases=AB[:1],
              deadline_s=None, fault_spec=None, bias_spec=None):
    """One streamed score request through ``pkg``'s ScoreClient ->
    (masked frames, counters, (model, fault) sequence)."""
    p = PKGS[pkg]
    scripts = [clone(s) if pkg == "ref" else port_script(s) for s in scripts]
    transport = p.transport(scripts)
    faults = []
    if fault_spec is not None:
        plan = p.res.FaultPlan.parse(fault_spec)
        draw = plan.next_fault

        def noted():
            fault = draw()
            faults.append(fault)
            return fault

        plan.next_fault = noted
        transport = p.res.FaultInjectionTransport(transport, plan)
    recorder = Recording(transport)
    pol = policy(p.res) if policy is not None else None
    chat = p.chat.DefaultChatClient(
        recorder, [p.chat.ApiBase(*ab) for ab in bases],
        backoff=p.chat.BackoffPolicy(max_elapsed_ms=0), resilience=pol)
    client = p.score.ScoreClient(
        chat, p.registry.InMemoryModelRegistry(),
        archive_fetcher=p.archive.InMemoryArchive(),
        rng_factory=lambda: random.Random(SEED), resilience=pol,
        bias_plan=(p.res.JudgeBiasPlan.parse(bias_spec)
                   if bias_spec else None))
    params = p.req.ChatCompletionCreateParams.from_json_obj(req_body)

    async def collect():
        token = None
        if deadline_s is not None:
            token = p.res.Deadline(deadline_s).activate()
        try:
            stream = await client.create_streaming(None, params)
            return [masked(pkg, item) async for item in stream]
        finally:
            if token is not None:
                p.res.Deadline.deactivate(token)

    frames = go(collect())
    counters = dict(pol.counters) if pol is not None else None
    return frames, counters, list(zip(recorder.models, faults))


def run_both(*args, **kw):
    ref = run_panel("ref", *args, **kw)
    port = run_panel("port", *args, **kw)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    return port


THREE = [{"model": "judge-a", "weight": {"type": "static", "weight": 2}},
         {"model": "judge-b", "weight": {"type": "static", "weight": 1}},
         {"model": "judge-c", "weight": {"type": "static", "weight": 1}}]


def by_model(judges, scripts):
    return [scripts[m] for m in judge_order(judges)]


def final(frames):
    return json.loads(frames[-1])


def test_quorum_degraded_panel_matches():
    t0 = time.monotonic()
    frames, counters, _ = run_both(
        body(THREE), by_model(THREE, {
            "judge-a": judge_script(KEYS[1]),
            "judge-b": judge_script(KEYS[1]),
            "judge-c": judge_script(KEYS[1], delays={0: 30.0})}),
        policy=lambda res: res.ResiliencePolicy(quorum_fraction=0.5))
    assert time.monotonic() - t0 < 5.0  # both stragglers were cancelled
    assert counters == {"quorum_degraded": 1}
    out = final(frames)
    assert out["degraded"] is True
    errors = [c["error"] for c in out["choices"] if c.get("error")]
    assert [e["code"] for e in errors] == [499]


def test_a_traced_quorum_cut_finishes_every_judge_span():
    """Traced, a quorum cut closes the cancelled judges' streams in their
    own pump tasks: every ``judge:stream`` span is finished, the trace is
    kept (``degraded``) and carries the quorum's explain record."""
    from llm_weighted_consensus_tpu_torch import obs

    judges = [{"model": f"judge-{i}", "weight": {"type": "static",
                                                "weight": 1}}
              for i in range(24)]
    # many chunks per judge: when the quorum decides, pumps wait on the
    # merge's full queue with their streams suspended at a yield
    chatty = Script([chunk_obj("I ", model="up-model")] * 6 + [
        chunk_obj(f"pick {KEYS[1]} as best.", model="up-model",
                  finish="stop")])
    scripts = [chatty for _ in range(22)] + [
        judge_script(KEYS[1], delays={0: 30.0}) for _ in range(2)]
    errors = []

    async def run():
        loop = asyncio.get_running_loop()
        loop.set_exception_handler(lambda _, ctx: errors.append(ctx))
        root = obs.start_trace("gateway:POST /score/completions",
                               sampled=False)
        token = root.activate()
        try:
            policy = port_res.ResiliencePolicy(quorum_fraction=0.5)
            chat = port_chat.DefaultChatClient(
                PortFakeTransport(scripts),
                [port_chat.ApiBase("https://a.example", "k")],
                backoff=port_chat.BackoffPolicy(max_elapsed_ms=0),
                resilience=policy)
            client = port_score.ScoreClient(
                chat, port_registry.InMemoryModelRegistry(),
                archive_fetcher=port_archive.InMemoryArchive(),
                rng_factory=lambda: random.Random(SEED), resilience=policy)
            params = port_req.ChatCompletionCreateParams.from_json_obj(
                body(judges))
            stream = await client.create_streaming(None, params)
            items = [item async for item in stream]
        finally:
            obs.Span.deactivate(token)
            root.finish()
        await asyncio.sleep(0.05)  # any finalizer task would run here
        return root.trace, items

    trace, items = go(run())
    assert errors == []
    assert items[-1].degraded is True
    record = trace.to_json_obj()
    spans = [sp for sp in record["spans"] if sp["name"] == "judge:stream"]
    assert len(spans) == 24
    assert all(sp["duration_ms"] is not None for sp in spans)
    assert trace.forced and record["force_reason"] == "degraded"
    assert record["spans"][0]["attributes"]["quorum"]["decided"] is True


def test_quorum_waits_when_the_argmax_can_flip():
    frames, counters, _ = run_both(
        body(THREE), by_model(THREE, {
            "judge-a": judge_script(KEYS[0]),
            "judge-b": judge_script(KEYS[2]),
            "judge-c": judge_script(KEYS[2], delays={0: 0.05})}),
        policy=lambda res: res.ResiliencePolicy(quorum_fraction=0.5))
    assert counters == {}
    assert "degraded" not in final(frames)


def test_a_hedge_that_wins_is_tallied_once_as_the_reference():
    judges = [{"model": "judge-a", "weight": {"type": "static",
                                              "weight": 1}}]
    frames, counters, seq = run_both(
        body(judges),
        [judge_script(KEYS[1], delays={0: 1.0}), judge_script(KEYS[1])],
        policy=lambda res: res.ResiliencePolicy(
            hedge=res.HedgePolicy(delay_ms=30.0)),
        bases=AB)
    assert counters == {"hedge_launched": 1, "hedge_won": 1}
    votes = [c for f in frames[1:-1] for c in json.loads(f)["choices"]
             if c["delta"].get("vote") is not None]
    assert len(votes) == 1
    weights = {c["index"]: c["weight"] for c in final(frames)["choices"]
               if c["index"] < 3}
    assert weights == {0: 0, 1: 1, 2: 0}


def test_deadline_degraded_panel_matches():
    judges = THREE[1:]
    t0 = time.monotonic()
    frames, counters, _ = run_both(
        body(judges), by_model(judges, {
            "judge-b": judge_script(KEYS[1]),
            "judge-c": judge_script(KEYS[1], delays={0: 30.0})}),
        policy=lambda res: res.ResiliencePolicy(), deadline_s=0.2)
    assert time.monotonic() - t0 < 5.0
    assert counters == {"deadline_degraded": 1}
    out = final(frames)
    assert out["degraded"] is True
    assert [c["error"]["code"] for c in out["choices"]
            if c.get("error")] == [504]


def test_all_failed_panel_matches():
    frames, counters, _ = run_both(
        body(THREE), [Script(status=503, body=b"{}"),
                      Script(status=500, body=b"{}"),
                      Script(status=503, body=b"{}")],
        policy=lambda res: res.ResiliencePolicy(
            quorum_fraction=0.5, retry_budget_tokens=2))
    assert frames[-1].startswith("error 500")
    assert counters == {}


@pytest.mark.parametrize("bias", ["judge=0,flip=1.0,seed=7",
                                  "judge=2,script=invert|ok"])
def test_a_judge_bias_plan_panel_matches(bias):
    frames, _, _ = run_both(
        body(THREE), by_model(THREE, {
            "judge-a": judge_script(KEYS[0]),
            "judge-b": judge_script(KEYS[1]),
            "judge-c": judge_script(KEYS[1])}),
        bias_spec=bias)
    assert "degraded" not in final(frames)


@pytest.mark.parametrize("spec", [
    "seed=7,5xx=0.3,connect=0.2",
    "seed=11,5xx=0.25,malformed=0.25,truncate=0.2",
    "script=ok|5xx|connect|ok|ok|5xx",
])
def test_a_fault_plan_faults_the_reference_judges(spec):
    judges = [{"model": f"j{i}", "weight": {"type": "static",
                                            "weight": 1 + i % 2}}
              for i in range(6)]
    scripts = [judge_script(KEYS[i % 3]) for i in range(6)]
    frames, counters, seq = run_both(
        body(judges), scripts, fault_spec=spec,
        policy=lambda res: res.ResiliencePolicy(
            quorum_fraction=0.5, retry_budget_tokens=4))
    assert len(seq) == 6
    assert [m for m, _ in seq] == judge_order(judges)


def test_no_policy_keeps_the_wire_format():
    frames, counters, _ = run_both(
        body(THREE[:1]), [judge_script(KEYS[0])])
    assert counters is None
    assert all('"degraded"' not in f for f in frames)


# -- through the port's server -----------------------------------------------------


def post_json(port, path, obj, headers=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"content-type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def get_json(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def serve(env):
    from llm_weighted_consensus_tpu_torch.serve import __main__ as serve_main
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    config = ServeConfig.from_env(env)
    server = serve_main.build_server(None, None, config, device="cpu")
    server.lifecycle.mark_ready()
    return server.start()


def test_a_quorum_degraded_answer_is_never_cached_through_the_route():
    judges = LoopbackJudges()
    panel = [{"model": "fast-a"}, {"model": "fast-b"}, {"model": "stall-c"}]
    server = serve({"OPENAI_API_BASE": judges.url, "OPENAI_API_KEY": "k",
                    "BACKOFF_MAX_ELAPSED_TIME_MILLIS": "0",
                    "RESILIENCE_QUORUM": "0.5", "SCORE_CACHE_TTL": "60",
                    "HOST_FASTPATH": "1"})
    try:
        req = body(panel, stream=True)
        answers = []
        for _ in range(2):
            status, raw = post_json(server.port, "/score/completions", req)
            assert status == 200 and raw.endswith(b"data: [DONE]\n\n")
            answers.append(raw)
        finals = [json.loads(raw.split(b"data: ")[-2]) for raw in answers]
        for out in finals:
            assert out["degraded"] is True
            assert [c["error"]["code"] for c in out["choices"]
                    if c.get("error")] == [499]
        # the repeat fanned out again: nothing degraded was cached
        assert judges.calls.count("stall-c") == 2
        assert finals[0]["id"] != finals[1]["id"]
        assert judges.wait_closed() == 0  # the stragglers hung up
        _, snap = get_json(server.port, "/metrics")
        assert snap["resilience"]["counters"] == {"quorum_degraded": 2}
        assert snap["score_cache"]["entries"] == 0
        assert server.chat_routes.fastpath_fallbacks == 0
    finally:
        server.close()
        judges.close()


def test_the_default_deadline_applies_without_a_header():
    judges = LoopbackJudges()
    panel = [{"model": "fast-a"}, {"model": "stall-b"}]
    server = serve({"OPENAI_API_BASE": judges.url, "OPENAI_API_KEY": "k",
                    "RESILIENCE_DEADLINE_MILLIS": "300"})
    try:
        t0 = time.monotonic()
        status, raw = post_json(server.port, "/score/completions",
                                body(panel))
        assert time.monotonic() - t0 < 5.0
        out = json.loads(raw)
        # the unary fold keeps the per-judge detail (the initial chunk's
        # `degraded` stays unset in the fold, as in the reference)
        assert status == 200
        assert [c["error"]["code"] for c in out["choices"]
                if c.get("error")] == [504]
        # a header wins over the default
        status, raw = post_json(server.port, "/score/completions",
                                body(panel[:1]),
                                headers={"x-deadline-ms": "5000"})
        assert status == 200
        assert not any(c.get("error") for c in json.loads(raw)["choices"])
        _, snap = get_json(server.port, "/metrics")
        assert snap["resilience"]["counters"]["deadline_degraded"] == 1
    finally:
        server.close()
        judges.close()
