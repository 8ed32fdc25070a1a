"""The host split below the knee: a traced run of the r10 and long-r5
cells at a CPU size reports the four per-layer metrics that read the
port's phase counters (``tokenize_ms.rest``, ``queue_ms.rest``,
``gateway_ms.rest``, ``held_idle_ms.rest``), each positive and under
the run's median latency."""

import pytest

import yardstick_helpers as h

SPLIT = ("tokenize_ms.rest", "queue_ms.rest", "gateway_ms.rest",
         "held_idle_ms.rest")


@pytest.mark.parametrize("name", [h.LATENCY, h.LONG])
def test_a_traced_run_reports_the_host_split(name):
    c = h.cell(name, candidates=8, clients=2, rate=10.0)
    out = h.run(c, seed=2147483901, seconds=1.5, trace=True)
    assert out["correct"]
    metrics = out["metrics"]
    assert set(SPLIT) <= set(metrics)
    assert {metrics[m]["unit"] for m in SPLIT} == {"ms"}
    plain = h.run(c, seed=2147483901, seconds=1.5)
    p50 = plain["metrics"]["p50_ms"]["value"]
    for m in SPLIT:
        assert 0 < metrics[m]["value"] < p50, (m, metrics[m], p50)
