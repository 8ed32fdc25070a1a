"""The traffic: requests are a function of (seed, client, index), every
request of a mix has the same lengths, and the mixes form the buckets
their cells state."""

import threading
import time

import numpy as np
import pytest
import yardstick_helpers as h

from benchmark import spec
from benchmark.check import reference_tokenizer
from benchmark.traffic.requests import RequestSource, model_texts
from llm_weighted_consensus_tpu_torch.models.embedder import _seq_bucket

CELLS = [h.COSINE, h.LATENCY, h.LONG, h.RM]


def _full(name):
    import json

    if name == h.RM:
        cfg = json.loads(h.RM_CONFIG.read_text())
        mix = json.loads(h.RM_MIX.read_text())
        return cfg, mix
    c = spec.Spec(h.ROOT).cell(name)
    return c.cfg, c.mix


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_requests(name):
    _, mix = _full(name)
    a, b = RequestSource(mix, 2 ** 31 + 11), RequestSource(mix, 2 ** 31 + 11)
    other = RequestSource(mix, 2 ** 31 + 12)
    for c, k in ((0, 0), (3, 17), (1_000_000, 1)):
        assert a.request(c, k).body == b.request(c, k).body
        assert a.request(c, k).body != other.request(c, k).body
    assert a.request(0, 1).body != a.request(0, 2).body


@pytest.mark.parametrize("name", CELLS)
def test_every_request_forms_the_cells_bucket(name):
    cfg, mix = _full(name)
    tok = reference_tokenizer(cfg)
    lo, hi = mix["candidate_tokens"]
    want = sorted(np.rint(np.linspace(lo, hi, mix["candidates"])).astype(int))
    longest = mix["candidate_tokens"][1] + 2 + (mix.get("prompt_tokens")
                                                or [0, 0])[1]
    bucket = 128 if longest <= 128 else 512
    for seed in (1, 99):
        src = RequestSource(mix, seed)
        for c, k in ((0, 0), (1, 5), (2, 9)):
            req = src.request(c, k)
            assert len(req.texts) == mix["candidates"]
            assert sorted(len(t.split()) for t in req.texts) == want
            lengths = [len(tok.encode(t)) for t in model_texts(req)]
            extra = len(req.prompt.split()) if req.prompt else 0
            assert sorted(lengths) == sorted(n + 2 + extra for n in want)
            assert _seq_bucket(max(lengths), 512) == bucket


def test_prompt_lengths_are_one_set_for_every_seed():
    _, mix = _full(h.RM)
    lo, hi = mix["prompt_tokens"]
    for seed in (3, 4):
        src = RequestSource(mix, seed)
        assert sorted(src.prompts.tolist()) == list(range(lo, hi + 1))


class FakeConnection:
    def close(self):
        pass


class FakeSession:
    """A session whose server answers at once, for the generators."""

    def __init__(self, seconds, delay=0.0):
        self.seconds, self.delay, self.grace_s = seconds, delay, 5.0
        self.records, self.lock = [], threading.Lock()
        self.window_start = self.window_end = float("inf")
        self.source = RequestSource(_full(CELLS[0])[1], 5)

    def connect(self):
        return FakeConnection()

    def post(self, conn, req):
        time.sleep(self.delay)
        return 200, b"{}"

    def request(self, c, k):
        return (c, k)

    def open_window(self):
        self.window_start = time.perf_counter()
        self.window_end = self.window_start + self.seconds

    def close_window(self, drained=False):
        if drained:
            self.closed_at = time.perf_counter()
        else:
            time.sleep(max(0.0, self.window_end - time.perf_counter()))
            self.closed_at = self.window_end

    def record(self, req, due, sent, done, status, body):
        with self.lock:
            self.records.append((req, due, sent, done))


def test_closed_loop_keeps_each_client_to_one_request():
    s = FakeSession(0.3, delay=0.01)
    out = spec.generator("closed_loop").drive({"clients": 3}, s)
    assert out["stuck_clients"] == 0
    for c in range(3):
        mine = sorted(r for r in s.records if r[0][0] == c)
        assert [r[0][1] for r in mine] == list(range(len(mine)))
        for a, b in zip(mine, mine[1:]):
            assert b[2] >= a[3]  # sent after the last one came back
    assert all(r[1] == r[2] for r in s.records)  # due at its send


def test_open_loop_sends_on_its_schedule_and_reports_lateness():
    s = FakeSession(0.5, delay=0.002)
    out = spec.generator("open_loop").drive(
        {"rate_per_s": 40, "senders": 4}, s)
    dues = sorted(r[1] - s.window_start for r in s.records)
    assert len(dues) == 20
    assert np.allclose(dues, np.arange(20) / 40, atol=1e-9)
    assert out["late_p50_ms"] is not None and out["late_max_ms"] >= 0
    assert {r[0] for r in s.records} == {(i % 4, i // 4) for i in range(20)}


def test_open_loop_drain_closes_after_every_due_request_is_answered():
    # answers slower than the schedule: a backlog is left at the close
    s = FakeSession(0.3, delay=0.05)
    out = spec.generator("open_loop").drive(
        {"rate_per_s": 40, "senders": 2, "close": "drain"}, s)
    assert out["stuck_clients"] == 0
    assert len(s.records) == 12  # every request due in the window
    last = max(r[3] for r in s.records)
    assert s.closed_at >= last > s.window_end
