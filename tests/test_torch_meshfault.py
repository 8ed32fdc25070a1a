"""The port's device-fault handling on the CPU against the JAX package's.

``resilience/meshfault.py``: the CUDA classification table, the
``DEVICE_FAULT_PLAN`` draws and scripts (byte for byte the reference's),
the manager's escalations and snapshot; the batcher's triage and CPU twin
against the JAX ``DeviceBatcher`` with a ``MeshFaultManager`` at the 1x1
mesh (``MESH_ENABLED=1 MESH_SHAPE=1x1``), both serving the committed
``tests/fixtures/bge_micro`` in f32 (answers within 1e-5); the watchdog's
switch of the twin on the port's ``Server``; and the knob table through
the JAX ``Config.from_env`` and the port's ``ServeConfig.from_env``.
"""

import asyncio
import dataclasses
import os
import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu import resilience as ref_res
from llm_weighted_consensus_tpu.errors import (
    DeadlineExceededError as RefDeadlineExceeded,
)
from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.models import loading as jax_loading
from llm_weighted_consensus_tpu.models import tokenizer as jax_tokenizer
from llm_weighted_consensus_tpu.models.embedder import TpuEmbedder
from llm_weighted_consensus_tpu.parallel.mesh import make_mesh
from llm_weighted_consensus_tpu.parallel.sharding import shard_embedder_mesh
from llm_weighted_consensus_tpu.serve.batcher import (
    DeviceBatcher as RefBatcher,
)
from llm_weighted_consensus_tpu.serve.config import Config as RefConfig
from llm_weighted_consensus_tpu.serve.metrics import Metrics as RefMetrics
from llm_weighted_consensus_tpu_torch import resilience as res
from llm_weighted_consensus_tpu_torch.errors import DeadlineExceededError
from llm_weighted_consensus_tpu_torch.models import (
    bert,
    convert,
    loading,
    tokenizer,
)
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.resilience.deadline import Deadline
from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher
from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
from llm_weighted_consensus_tpu_torch.serve.gateway import Server
from llm_weighted_consensus_tpu_torch.serve.metrics import Metrics

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")
TOL = 1e-5
TEXTS = ["paris is the capital of france", "the capital of france is paris",
         "bananas are curved and yellow", "paris, on the seine"]
EMBEDS = ["alpha beta gamma", "delta epsilon"]


# -- classification ------------------------------------------------------------


class AcceleratorError(Exception):
    """Newer torch's CUDA error type, by name (torch.AcceleratorError
    where this torch has it)."""


ACCEL = getattr(torch, "AcceleratorError", AcceleratorError)


def _oom():
    return torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 80.00 GiB (GPU 0; 79.11 GiB "
        "total capacity)")


CLASSIFY = [
    ("injected transient", lambda: res.InjectedTransientError("x"),
     "transient"),
    ("injected persistent", lambda: res.InjectedPersistentError("x"),
     "persistent"),
    ("injected hang", lambda: res.InjectedHangError("x"), "transient"),
    ("torch OOM", _oom, "transient"),
    ("OOM text", lambda: RuntimeError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB"), "transient"),
    ("wrapper allocation", lambda: RuntimeError(
        "lwc_attention_tma: CUDA error 2 at launch"), "transient"),
    ("illegal address", lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered\nCUDA kernel "
        "errors might be asynchronously reported"), "persistent"),
    ("illegal address, accelerator", lambda: ACCEL(
        "CUDA error: an illegal memory access was encountered\nSearch for "
        "`cudaErrorIllegalAddress' in the CUDA docs"), "persistent"),
    ("device-side assert", lambda: ACCEL(
        "CUDA error: device-side assert triggered"), "persistent"),
    ("hardware stack", lambda: RuntimeError(
        "CUDA error: hardware stack error"), "persistent"),
    ("illegal instruction", lambda: RuntimeError(
        "CUDA error: an illegal instruction was encountered"), "persistent"),
    ("misaligned", lambda: RuntimeError("CUDA error: misaligned address"),
     "persistent"),
    ("address space", lambda: RuntimeError(
        "CUDA error: operation not supported on global/shared address "
        "space"), "persistent"),
    ("invalid pc", lambda: RuntimeError(
        "CUDA error: invalid program counter"), "persistent"),
    ("launch failure", lambda: RuntimeError(
        "CUDA error: unspecified launch failure"), "persistent"),
    ("ecc", lambda: RuntimeError(
        "CUDA error: uncorrectable ECC error encountered"), "persistent"),
    *[(f"wrapper sticky {code}", lambda code=code: RuntimeError(
        f"lwc_cosine_vote_cluster: CUDA error {code} at launch"),
        "persistent")
      for code in (214, 700, 710, 714, 715, 716, 717, 718, 719)],
    ("wrapper invalid value", lambda: RuntimeError(
        "lwc_attention: CUDA error 1 at launch"), None),
    ("wrapper other", lambda: RuntimeError(
        "lwc_quant_matmul_tma: CUDA error 98 at launch"), "transient"),
    ("other cuda", lambda: RuntimeError(
        "CUDA error: too many resources requested for launch"), "transient"),
    ("other accelerator", lambda: ACCEL("something the CUDA runtime said"),
     "transient"),
    ("app value error", lambda: ValueError("bad input"), None),
    ("app runtime error", lambda: RuntimeError("app bug"), None),
    ("app key error", lambda: KeyError("x"), None),
]


@pytest.mark.parametrize("make, want", [c[1:] for c in CLASSIFY],
                         ids=[c[0] for c in CLASSIFY])
def test_classify_dispatch_error(make, want):
    assert res.classify_dispatch_error(make()) == want


def test_injected_kinds_classify_as_the_reference():
    for name in ("InjectedTransientError", "InjectedPersistentError",
                 "InjectedHangError"):
        assert res.classify_dispatch_error(getattr(res, name)("x")) == \
            ref_res.classify_dispatch_error(getattr(ref_res, name)("x"))
    for exc in (ValueError("x"), RuntimeError("app bug")):
        assert res.classify_dispatch_error(exc) is None
        assert ref_res.classify_dispatch_error(exc) is None


# -- plans ---------------------------------------------------------------------


PLANS = [
    "seed=42,persistent=0.05,transient=0.2,hang=0.1",
    "seed=3,transient=0.5",
    "seed=7,hang=0.3,hang_ms=12",
    "script=ok|transient|persistent||hang|ok,hang_ms=7",
    "transient=1.0",
    "",
]


@pytest.mark.parametrize("spec", PLANS)
def test_plan_draws_equal_the_references(spec):
    port, ref = (res.DeviceFaultPlan.parse(spec),
                 ref_res.DeviceFaultPlan.parse(spec))
    assert [port.next_fault() for _ in range(300)] == [
        ref.next_fault() for _ in range(300)]
    assert port.snapshot() == ref.snapshot()
    assert port.hang_ms == ref.hang_ms and port.seed == ref.seed


@pytest.mark.parametrize("spec", [
    "bogus", "script=ok|melt", "color=1", "seed=x", "transient=lots",
    "hang_ms=soon",
])
def test_plan_parse_errors_are_the_references(spec):
    with pytest.raises(ValueError) as want:
        ref_res.DeviceFaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        res.DeviceFaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_scripted_plan_and_injection_seam():
    mgr = res.MeshFaultManager(
        None, fault_plan=res.DeviceFaultPlan.scripted(
            [None, "transient", "persistent", "hang"], hang_ms=5.0))
    mgr.maybe_inject()
    for exc in (res.InjectedTransientError, res.InjectedPersistentError):
        with pytest.raises(exc):
            mgr.maybe_inject()
    t0 = time.perf_counter()
    with pytest.raises(res.InjectedHangError):
        mgr.maybe_inject()
    assert time.perf_counter() - t0 >= 0.005
    mgr.maybe_inject()  # healthy after the script
    assert mgr.fault_plan.snapshot() == {
        "requests": 5,
        "injected": {"transient": 1, "persistent": 1, "hang": 1}}


# -- escalation ----------------------------------------------------------------


def _drive(mgr, mod, steps):
    out = []
    for step in steps:
        if step == "ok":
            mgr.note_dispatch_ok()
        elif step == "trip":
            mgr.note_watchdog_trip()
        else:
            out.append(mgr.classify(getattr(mod, step)("x")))
    return out


ESCALATIONS = [
    ["InjectedTransientError"] * 7,
    ["InjectedTransientError", "ok", "InjectedTransientError",
     "InjectedTransientError", "InjectedTransientError", "ok"],
    ["trip", "InjectedHangError", "InjectedTransientError"],
    ["InjectedTransientError", "InjectedPersistentError",
     "InjectedTransientError", "InjectedTransientError",
     "InjectedTransientError"],
    ["trip", "ok", "InjectedTransientError"],
]


@pytest.mark.parametrize("retries", [0, 2, 5])
@pytest.mark.parametrize("steps", ESCALATIONS,
                         ids=[f"seq{i}" for i in range(len(ESCALATIONS))])
def test_escalation_equals_the_references(steps, retries):
    port = res.MeshFaultManager(None, transient_retries=retries)
    ref = ref_res.MeshFaultManager(None, shape=(1, 1),
                                   transient_retries=retries)
    assert _drive(port, res, steps) == _drive(ref, ref_res, steps)


def test_one_card_ladder_is_spent_from_the_start():
    mgr = res.MeshFaultManager(None)
    assert mgr.build_ladder() == [(1, 1)]
    assert mgr.exhausted and not mgr.degraded
    assert mgr.downsize() is False
    assert mgr.try_recover() is False
    assert mgr.current_shape == (1, 1)
    # a shape past one device needs an embedder placed on its mesh
    with pytest.raises(RuntimeError, match="mesh-sharded embedder"):
        res.MeshFaultManager(None, shape=(2, 1)).build_ladder()


# -- batcher drills against the reference --------------------------------------


@pytest.fixture(scope="module")
def micro():
    """(JAX embedder on the 1x1 mesh, JAX twin, port embedder, port twin),
    all on the fixture's weights."""
    port_cfg = loading.load_hf_config(FIXTURE)
    jax_cfg = jax_configs.BertConfig(
        **{f.name: getattr(port_cfg, f.name)
           for f in dataclasses.fields(port_cfg)})
    params = jax_loading.load_params(FIXTURE, jax_cfg)
    state = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), port_cfg)
    vocab = loading.find_vocab(FIXTURE)

    def ref_emb():
        return TpuEmbedder("bge-micro", params=params, config=jax_cfg,
                           tokenizer=jax_tokenizer.load_tokenizer(vocab),
                           max_tokens=64)

    def port_emb():
        return TorchEmbedder(
            "bge-micro", model=bert.from_hf_state_dict(state, port_cfg,
                                                       device="cpu"),
            config=port_cfg, tokenizer=tokenizer.load_tokenizer(vocab),
            max_tokens=64, device="cpu")

    ref = ref_emb()
    shard_embedder_mesh(ref, make_mesh(dp=1, tp=1))
    twin = port_emb()
    twin.label_suffix = "@cpu"
    return ref, ref_emb(), port_emb(), twin


def _ref_manager(emb, plan=None, **kw):
    mgr = ref_res.MeshFaultManager(emb, shape=(1, 1), fault_plan=plan, **kw)
    mgr.build_ladder()
    return mgr


def _ref_run(micro, plan, twin=False, deadline_ms=None, **kw):
    """The reference's batcher under ``plan`` -> (answers or exceptions,
    batcher, manager)."""
    ref, ref_twin, _, _ = micro
    mgr = _ref_manager(ref, ref_res.DeviceFaultPlan.parse(plan), **kw)
    batcher = RefBatcher(ref, RefMetrics(), window_ms=30.0, meshfault=mgr,
                         fallback_embedder=ref_twin if twin else None)

    async def run():
        token = (ref_res.Deadline(deadline_ms / 1e3).activate()
                 if deadline_ms else None)
        try:
            return await asyncio.gather(
                batcher.consensus(TEXTS, 0.05), batcher.embed(EMBEDS),
                return_exceptions=True)
        finally:
            if token is not None:
                ref_res.Deadline.deactivate(token)

    return asyncio.run(run()), batcher, mgr


def _port_run(micro, plan, twin=False, deadline_ms=None, **kw):
    _, _, port, port_twin = micro
    mgr = res.MeshFaultManager(port, fault_plan=res.DeviceFaultPlan.parse(
        plan), **kw) if plan is not None else None
    batcher = DeviceBatcher(port, Metrics(), window_ms=30.0, meshfault=mgr,
                            fallback_embedder=port_twin if twin else None)
    with batcher:
        token = (Deadline(deadline_ms / 1e3).activate()
                 if deadline_ms else None)
        try:
            futures = [batcher.submit_consensus(TEXTS, 0.05),
                       batcher.submit_embed(EMBEDS)]
        finally:
            if token is not None:
                Deadline.deactivate(token)
        out = []
        for f in futures:
            try:
                out.append(f.result(60))
            except Exception as exc:
                out.append(exc)
        return out, batcher, mgr


def _close(got, want):
    (conf, tokens), (vecs, etokens) = got
    (rconf, rtokens), (rvecs, retokens) = want
    np.testing.assert_allclose(conf, np.asarray(rconf), atol=TOL)
    np.testing.assert_allclose(vecs, np.asarray(rvecs), atol=TOL)
    assert (tokens, etokens) == (rtokens, retokens)


@pytest.fixture(scope="module")
def clean(micro):
    return _port_run(micro, None)[0]


def test_transient_retry_answers_equal_a_clean_run(micro, clean):
    got, batcher, mgr = _port_run(micro, "script=transient")
    want, ref_batcher, ref_mgr = _ref_run(micro, "script=transient")
    _close(got, clean)
    _close(got, want)
    assert mgr.snapshot() == ref_mgr.snapshot()
    assert mgr.snapshot()["re_dispatches"] >= 1
    util = batcher.utilization()
    assert util["fallback_dispatches"] == 0 and not util["fallback_active"]


def test_persistent_without_a_twin_fails_the_group(micro):
    got, batcher, mgr = _port_run(micro, "script=persistent")
    want, _, ref_mgr = _ref_run(micro, "script=persistent")
    failed = [type(x).__name__ for x in got if isinstance(x, Exception)]
    assert failed == [type(x).__name__ for x in want
                      if isinstance(x, Exception)]
    assert failed and set(failed) == {"InjectedPersistentError"}
    assert batcher.utilization()["fallback_active"] is False
    assert mgr.snapshot() == ref_mgr.snapshot()


def test_persistent_with_a_twin_switches_and_matches_the_references(micro):
    got, batcher, mgr = _port_run(micro, "script=persistent", twin=True)
    want, ref_batcher, ref_mgr = _ref_run(micro, "script=persistent",
                                          twin=True)
    _close(got, want)
    util, ref_util = batcher.utilization(), ref_batcher.utilization()
    assert util["fallback_active"] is ref_util["fallback_active"] is True
    # the re-queued group, and the other one if it was planned after
    # the switch (both packages' grouping is timing-dependent here)
    assert 1 <= util["fallback_dispatches"] <= 2
    assert 1 <= ref_util["fallback_dispatches"] <= 2
    snap, ref_snap = mgr.snapshot(), ref_mgr.snapshot()
    # the plan's draw count follows that grouping too: one draw per card
    # dispatch
    assert snap.pop("fault_plan")["injected"] == ref_snap.pop(
        "fault_plan")["injected"] == {"persistent": 1}
    assert snap == ref_snap
    # the twin's device timings carry its own label suffix
    from llm_weighted_consensus_tpu_torch.obs import phases

    assert any(k.endswith("@cpu") for k in
               phases.aggregator().device_snapshot())


def test_requeue_sheds_an_expired_deadline_with_504(micro):
    got, batcher, _ = _port_run(micro, "script=hang|hang,hang_ms=80",
                                deadline_ms=30)
    want, ref_batcher, _ = _ref_run(micro, "script=hang|hang,hang_ms=80",
                                    deadline_ms=30)
    assert all(isinstance(x, DeadlineExceededError) for x in got)
    assert all(isinstance(x, RefDeadlineExceeded) for x in want)
    assert [x.status() for x in got] == [x.status() for x in want] == [
        504, 504]
    assert batcher.shed_deadline == ref_batcher.shed_deadline >= 1


def test_redispatch_limit_is_counted(micro):
    plan = "script=" + "|".join(["transient"] * (
        DeviceBatcher.REDISPATCH_LIMIT + 1))
    assert DeviceBatcher.REDISPATCH_LIMIT == RefBatcher.REDISPATCH_LIMIT
    _, _, port, _ = micro
    mgr = res.MeshFaultManager(port, transient_retries=100,
                               fault_plan=res.DeviceFaultPlan.parse(plan))
    metrics = Metrics()
    with DeviceBatcher(port, metrics, window_ms=5.0, meshfault=mgr) as b:
        with pytest.raises(res.InjectedTransientError):
            b.embed(["recycled until the limit"])
        util = b.utilization()
    ref, _, _, _ = micro
    ref_mgr = _ref_manager(ref, ref_res.DeviceFaultPlan.parse(plan),
                           transient_retries=100)
    ref_b = RefBatcher(ref, RefMetrics(), window_ms=5.0, meshfault=ref_mgr)

    async def run():
        with pytest.raises(ref_res.InjectedTransientError):
            await ref_b.embed(["recycled until the limit"])

    asyncio.run(run())
    assert util["shed_redispatch_limit"] == ref_b.shed_redispatch_limit == 1
    assert metrics.snapshot()["series"]["device:shed:redispatch"][
        "errors"] == 1
    assert mgr.snapshot() == ref_mgr.snapshot()
    assert mgr.snapshot()["re_dispatches"] == DeviceBatcher.REDISPATCH_LIMIT


def test_application_errors_keep_the_fail_the_group_path(micro):
    _, _, port, twin = micro
    mgr = res.MeshFaultManager(port)
    with DeviceBatcher(port, Metrics(), window_ms=5.0, meshfault=mgr,
                       fallback_embedder=twin) as b:
        def bad_dispatch(group, embedder):
            raise ValueError("tokenizer exploded")

        b._dispatch_embed = bad_dispatch
        with pytest.raises(ValueError, match="tokenizer exploded"):
            b.embed(["doomed"])
        assert b.utilization()["fallback_active"] is False
    snap = mgr.snapshot()
    assert snap["re_dispatches"] == 0 and snap["downsizes"] == 0


def test_a_real_oom_on_the_dispatch_retries_on_the_same_shape(micro, clean):
    """A dispatch raising torch's own OutOfMemoryError (as the card's
    allocator does) is transient: re-queued, then answered."""
    _, _, port, _ = micro
    mgr = res.MeshFaultManager(port)
    with DeviceBatcher(port, Metrics(), window_ms=30.0, meshfault=mgr) as b:
        real = b._dispatch_consensus
        calls = []

        def oom_once(group, embedder):
            calls.append(len(group))
            if len(calls) == 1:
                raise _oom()
            return real(group, embedder)

        b._dispatch_consensus = oom_once
        conf, tokens = b.consensus(TEXTS)
    np.testing.assert_allclose(conf, clean[0][0], atol=TOL)
    assert len(calls) == 2 and mgr.snapshot()["re_dispatches"] == 1


def test_a_manager_without_faults_is_todays_behaviour(micro, clean):
    got, batcher, _ = _port_run(micro, "")
    for (a, ta), (b, tb) in zip(got, clean):
        assert np.array_equal(a, b) and ta == tb
    util = batcher.utilization()
    assert (util["fallback_active"], util["fallback_dispatches"],
            util["shed_redispatch_limit"]) == (False, 0, 0)


def test_the_stream_buffer_follows_the_serving_model(micro):
    """A stream's buffer moves to the twin's device when the twin serves
    its update, and new buffers are allocated there."""
    _, _, port, twin = micro
    with DeviceBatcher(port, Metrics(), window_ms=5.0,
                       fallback_embedder=twin) as b:
        buf = b.stream_buffer(16)
        first = b.submit_stream("alpha", buf, 0).result(60)
        b.use_fallback(True)
        assert b.fallback_active
        second = b.submit_stream("beta", buf, 1).result(60)
        assert b.utilization()["fallback_dispatches"] == 1
        want = port.stream_vote_update(
            "beta", port.stream_buffer(16).copy_(buf), 1)
    assert first.shape == second.shape == (16,)
    np.testing.assert_allclose(second, want, atol=TOL)


# -- the watchdog's switch ---------------------------------------------------------


def test_watchdog_trip_and_recovery_switch_the_twin(micro):
    """Without a manager a trip turns the twin on and the recovery off;
    the device routes never shed while a twin absorbs the work."""
    _, _, port, twin = micro
    with Server(port, watchdog_ms=60_000, fallback_embedder=twin) as srv:
        srv.watchdog.on_trip("consensus", 61_000.0)
        assert srv.batcher.fallback_active
        srv.watchdog._healthy = False  # the overdue state the trip set
        assert srv._device_gate() is None
        assert srv.lifecycle.ready() == (False, "device_unhealthy")
        srv.watchdog.on_recover()
        assert not srv.batcher.fallback_active
    with Server(port, watchdog_ms=60_000) as srv:
        srv.watchdog._healthy = False
        assert srv._device_gate() == "device_unhealthy"


def test_watchdog_trip_under_the_manager_goes_to_the_ladder(micro):
    """Under a manager a trip marks the next fault persistent (the
    ladder decides); a twin switched on by the spent ladder survives
    the recovery."""
    _, _, port, twin = micro
    mgr = res.MeshFaultManager(port)
    with Server(port, watchdog_ms=60_000, fallback_embedder=twin,
                meshfault=mgr) as srv:
        srv.watchdog.on_trip("consensus", 61_000.0)
        assert not srv.batcher.fallback_active
        assert mgr.classify(res.InjectedHangError("x")) == "persistent"
        srv.batcher.use_fallback(True)  # the spent ladder's switch
        srv.watchdog.on_recover()
        assert srv.batcher.fallback_active
        snap = srv.metrics.snapshot()
    assert snap["meshfault"]["ladder"] == [[1, 1]]
    assert snap["device_batcher"]["fallback_active"] is True


def test_hang_under_the_watchdog_switches_to_the_twin(micro, clean):
    """The drill end to end on the CPU: the watchdog sees the injected
    hang overdue, its raise classifies persistent, the spent ladder
    switches to the twin, and the re-queued items answer from it."""
    _, _, port, twin = micro
    mgr = res.MeshFaultManager(port, fault_plan=res.DeviceFaultPlan.parse(
        "script=hang,hang_ms=400"))
    with Server(port, watchdog_ms=100, watchdog_interval_ms=10,
                fallback_embedder=twin, meshfault=mgr, window_ms=5.0) as srv:
        conf, _ = srv.batcher.consensus(TEXTS)
        assert srv.watchdog.trips == 1
        assert srv.batcher.fallback_active
        deadline = time.monotonic() + 5
        while not srv.watchdog.healthy() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.watchdog.recoveries == 1
        assert srv.batcher.fallback_active  # survives the recovery
    np.testing.assert_allclose(conf, clean[0][0], atol=TOL)
    assert mgr.snapshot()["re_dispatches"] == 1


# -- the knobs -----------------------------------------------------------------------


MESH = {"MESH_ENABLED": "1"}
FIELDS = (
    "device_watchdog_cpu_fallback", "profile_dir", "mesh_enabled",
    "mesh_shape", "mesh_dp", "mesh_tp", "mesh_sp", "long_context_warmup",
    "mesh_fault_enabled", "mesh_fault_transient_retries",
    "mesh_fault_probe_millis", "device_fault_plan",
)
ACCEPTED = {
    "defaults": {},
    "mesh": MESH,
    "mesh 1x1": {**MESH, "MESH_SHAPE": "1x1"},
    "mesh 1x1x1": {**MESH, "MESH_SHAPE": "1x1x1"},
    "fault knobs": {**MESH, "MESH_FAULT_ENABLED": "1",
                    "MESH_FAULT_TRANSIENT_RETRIES": "5",
                    "MESH_FAULT_PROBE_MILLIS": "250",
                    "DEVICE_FAULT_PLAN": "seed=9,transient=0.1"},
    "twin off mesh": {"DEVICE_WATCHDOG_MILLIS": "1000",
                      "DEVICE_WATCHDOG_CPU_FALLBACK": "1"},
    "twin under the ladder": {
        **MESH, "MESH_FAULT_ENABLED": "1", "DEVICE_WATCHDOG_MILLIS": "500",
        "DEVICE_WATCHDOG_CPU_FALLBACK": "1",
        "DEVICE_FAULT_PLAN": "script=ok|hang|ok,hang_ms=900"},
    "profile dir": {"PROFILE_DIR": "/tmp/lwc-profiles"},
    "legacy tp 1": {"MESH_TP": "1"},
    "retries 0": {**MESH, "MESH_FAULT_ENABLED": "1",
                  "MESH_FAULT_TRANSIENT_RETRIES": "0"},
}
REFUSED = {
    "shape without mesh": {"MESH_SHAPE": "1x1"},
    "malformed shape": {**MESH, "MESH_SHAPE": "4by2"},
    "shape axis 0": {**MESH, "MESH_SHAPE": "0x1"},
    "mesh and legacy dp": {**MESH, "MESH_DP": "2"},
    "mesh and legacy tp": {**MESH, "MESH_TP": "2"},
    "mesh and legacy sp": {**MESH, "MESH_SP": "1"},
    "ring warmup without sp": {"LONG_CONTEXT_WARMUP": "4x64"},
    "malformed ring warmup": {"LONG_CONTEXT_WARMUP": "4"},
    "faults without mesh": {"MESH_FAULT_ENABLED": "1"},
    "plan without faults": {**MESH, "DEVICE_FAULT_PLAN": "seed=1"},
    "negative probe": {**MESH, "MESH_FAULT_ENABLED": "1",
                       "MESH_FAULT_PROBE_MILLIS": "-1"},
    "negative retries": {**MESH, "MESH_FAULT_ENABLED": "1",
                         "MESH_FAULT_TRANSIENT_RETRIES": "-1"},
    "twin without watchdog": {"DEVICE_WATCHDOG_CPU_FALLBACK": "1"},
    "twin on mesh without ladder": {
        **MESH, "DEVICE_WATCHDOG_MILLIS": "1000",
        "DEVICE_WATCHDOG_CPU_FALLBACK": "1"},
}
# meshes, the legacy hooks and ring buckets: both packages accept the
# knobs; on a host with one device both refuse to build the mesh, with the
# reference's make_mesh message (its make_mesh call beside each)
ONE_CARD_REFUSED = {
    "mesh 4x2": {**MESH, "MESH_SHAPE": "4x2"},
    "mesh 1x1x2": {**MESH, "MESH_SHAPE": "1x1x2"},
    "ring mesh": {**MESH, "MESH_SHAPE": "2x2x2",
                  "LONG_CONTEXT_WARMUP": "4x64"},
    "legacy dp": {"MESH_DP": "2"},
    "legacy tp": {"MESH_TP": "2"},
    "legacy sp": {"MESH_SP": "2"},
}
REF_MAKE_MESH = {
    "mesh 4x2": dict(dp=4, tp=2),
    "mesh 1x1x2": dict(dp=1, tp=1, sp=2),
    "ring mesh": dict(dp=2, tp=2, sp=2),
    "legacy dp": dict(dp=2, tp=1),
    "legacy tp": dict(dp=None, tp=2),
    "legacy sp": dict(dp=None, tp=2, names=("dp", "sp")),
}


def _plan_snapshot(config):
    plan = config.device_fault_injection_plan()
    return None if plan is None else (plan.seed, plan.hang_ms,
                                      plan.probabilities, plan._script)


@pytest.mark.parametrize("env", list(ACCEPTED.values()), ids=list(ACCEPTED))
def test_accepted_knobs_parse_as_the_references(env):
    ref, port = RefConfig.from_env(env), ServeConfig.from_env(env)
    for name in FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    assert _plan_snapshot(port) == _plan_snapshot(ref)


def _leading(message: str) -> str:
    return message.split(":")[0]


@pytest.mark.parametrize("env", list(REFUSED.values()), ids=list(REFUSED))
def test_refused_knobs_are_refused_as_the_reference_does(env):
    with pytest.raises(ValueError) as want:
        RefConfig.from_env(env)
    with pytest.raises(ValueError) as got:
        ServeConfig.from_env(env)
    assert _leading(str(got.value)) == _leading(str(want.value))


@pytest.mark.parametrize("env", list(ONE_CARD_REFUSED.values()),
                         ids=list(ONE_CARD_REFUSED))
def test_mesh_knobs_parse_as_the_references(env):
    ref, port = RefConfig.from_env(env), ServeConfig.from_env(env)
    for name in FIELDS:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("case", list(ONE_CARD_REFUSED))
def test_the_port_refuses_more_than_one_card(case):
    """On a host with one device the mesh these knobs ask for cannot be
    built: the port refuses at build with the reference's message."""
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_embedder,
    )

    with pytest.raises(ValueError) as want:
        make_mesh(devices=jax.devices()[:1], **REF_MAKE_MESH[case])
    env = {**ONE_CARD_REFUSED[case], "EMBEDDER_MODEL": "test-tiny",
           "LWC_ALLOW_RANDOM_PARAMS": "1"}
    ServeConfig.from_env(env)
    with pytest.raises(ValueError) as got:
        build_embedder(env, device="cpu")  # the CPU is one device
    assert str(got.value) == str(want.value)


def test_the_fault_ladder_past_one_device_is_accepted():
    """The knobs of a ladder past one rung parse as the reference's (the
    refusal the port made before its ladder walked is gone)."""
    for shape in ("2x1", "4x2", "2x2x2"):
        env = {**MESH, "MESH_SHAPE": shape, "MESH_FAULT_ENABLED": "1",
               "DEVICE_WATCHDOG_MILLIS": "1000",
               "DEVICE_WATCHDOG_CPU_FALLBACK": "1"}
        ref, port = RefConfig.from_env(env), ServeConfig.from_env(env)
        for name in FIELDS:
            assert getattr(port, name) == getattr(ref, name), name


def test_a_malformed_plan_is_refused_when_the_server_builds_it():
    env = {**MESH, "MESH_FAULT_ENABLED": "1", "DEVICE_FAULT_PLAN": "melt=1"}
    for config in (RefConfig.from_env(env), ServeConfig.from_env(env)):
        with pytest.raises(ValueError, match="unknown key 'melt'"):
            config.device_fault_injection_plan()


def test_build_server_wires_the_manager_the_twin_and_the_labels(micro):
    from llm_weighted_consensus_tpu_torch.serve.__main__ import build_server

    _, _, port, twin = micro
    config = ServeConfig.from_env({
        **MESH, "MESH_FAULT_ENABLED": "1", "DEVICE_WATCHDOG_MILLIS": "5000",
        "DEVICE_WATCHDOG_CPU_FALLBACK": "1", "WARMUP": "4x16",
        "DEVICE_FAULT_PLAN": "script=ok", "MEMGUARD": "0"})
    srv = build_server(port, None, config, twin=twin)
    try:
        assert srv.batcher.fallback_embedder is twin
        assert srv.meshfault.fault_plan is not None
        assert port.label_suffix == "@dp1xtp1"
        srv.meshfault.probe_fn()  # the first warmed spec's clean forward
        snap = srv.metrics.snapshot()
        assert snap["mesh"]["devices"] == 1
        assert snap["meshfault"]["fault_plan"] == {"requests": 0,
                                                   "injected": {}}
    finally:
        srv.close()
        port.label_suffix = ""
    # the knob off drops a twin the caller passed; no mesh, no suffix
    srv = build_server(port, None, ServeConfig.from_env({"MEMGUARD": "0"}),
                       twin=twin)
    try:
        assert srv.batcher.fallback_embedder is None
        assert srv.meshfault is None and port.label_suffix == ""
        assert "mesh" not in srv.metrics.snapshot()
    finally:
        srv.close()


def test_build_cpu_twin_strips_quantization_and_mesh():
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_cpu_twin,
        build_embedder,
    )

    env = {"EMBEDDER_MODEL": "test-tiny", "EMBEDDER_MAX_TOKENS": "32",
           "LWC_ALLOW_RANDOM_PARAMS": "1", "EMBEDDER_QUANTIZE": "int8",
           "MESH_ENABLED": "1"}
    twin = build_cpu_twin(env)
    assert twin.device.type == "cpu" and twin.dtype == torch.float32
    assert twin.config.quantize == "none" and twin.label_suffix == "@cpu"
    # the same seed's weights as the served embedder
    served = build_embedder({**env, "EMBEDDER_QUANTIZE": "none"},
                            device="cpu")
    for a, b in zip(twin.model.parameters(), served.model.parameters()):
        assert torch.equal(a, b)
    assert build_cpu_twin({"EMBEDDER_MODEL": "no-such-model"}) is None


def test_the_random_plan_draws_once_per_dispatch():
    """One ``random.Random(seed)`` draw per dispatch in dispatch order:
    the plan's sequence is the seeded generator's."""
    plan = res.DeviceFaultPlan.parse("seed=5,transient=0.25,hang=0.25")
    rng = random.Random(5)
    want = []
    for _ in range(50):
        d = rng.random()
        want.append("transient" if d < 0.25 else "persistent" if d < 0.25
                    else "hang" if d < 0.5 else None)
    assert [plan.next_fault() for _ in range(50)] == want


# -- a failed dispatch's pinned buffers ----------------------------------------------


def test_a_failed_dispatch_never_frees_its_staging_buffers():
    """After a sticky CUDA error, freeing a pinned buffer that served a
    copy aborts the process; a failed dispatch's buffers are retained
    (recycled while their bucket has room, kept past it)."""
    from llm_weighted_consensus_tpu_torch.models import dispatch_seam as seam
    from llm_weighted_consensus_tpu_torch.models.graphs import GraphTable

    pool = seam.StagingPool(per_bucket=1)
    a, b = torch.zeros(2), torch.zeros(2)
    pool.retain(a)
    pool.retain(b)
    assert pool.acquire((2,), torch.float32) is a and pool._retained == [b]

    class Handle:
        host = torch.zeros(3)

    def sticky(out):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    handle, staged = Handle(), torch.zeros(4)
    sink = seam.DispatchSink()
    sink.staged = [staged]
    sink.add(seam.PendingDispatch("vote1(n=2,s=4)", 0.0, handle, wait=sticky))
    kept, released = [], []
    with pytest.raises(RuntimeError):
        seam.drain_sink(sink, release=released.append, retain=kept.append)
    assert released == [] and [id(t) for t in kept] == [id(staged),
                                                         id(handle.host)]

    def asserting(ids, mask):
        raise RuntimeError("CUDA error: device-side assert triggered")

    pool = seam.StagingPool(per_bucket=0)
    mask = np.ones((2, 4), np.int32)
    with pytest.raises(RuntimeError):
        GraphTable("cpu").dispatch(
            ("vote1", 2, 4), "vote1(n=2,s=4)",
            {"ids": np.zeros((2, 4), np.int32), "mask": mask}, asserting,
            lambda out: out, pool)
    assert len(pool._retained) == 2


# -- the ladder past one rung, against the reference's ---------------------------
#
# Both managers walk test-tiny in f32 with the same weights: the
# reference's ``TpuEmbedder`` on the conftest's virtual CPU devices, the
# port's ``TorchEmbedder`` over ``[cpu] * k`` (its shards share the CPU as
# a mesh's shards share one card).

CPUS = [torch.device("cpu")] * 8
LN, LS, LR = 4, 16, 2  # the warmed (N, S) spec and R bucket
LADDER_TEXTS = [f"candidate number {i % 3} under fault" for i in range(6)]
# the buckets the drives below dispatch at (their 6 and 4 candidates)
WARM = [(6, LS), (LN, LS)]


@pytest.fixture(scope="module")
def tiny_tree():
    ref = TpuEmbedder("test-tiny", config=jax_configs.TEST_TINY,
                      max_tokens=32, seed=3)
    return jax.tree_util.tree_map(np.asarray, ref.params), ref.tokenizer


def _ref_tiny(tiny_tree, dp, tp, sp=1):
    from llm_weighted_consensus_tpu.parallel.mesh import make_mesh as jm

    ref = TpuEmbedder("test-tiny", config=jax_configs.TEST_TINY,
                      max_tokens=32, seed=3)
    if dp:
        shard_embedder_mesh(ref, jm(dp=dp, tp=tp, sp=sp))
    return ref


def _port_tiny(tiny_tree, dp, tp, sp=1):
    from llm_weighted_consensus_tpu_torch.models import configs as pc
    from llm_weighted_consensus_tpu_torch.parallel.mesh import make_mesh as pm
    from llm_weighted_consensus_tpu_torch.parallel.sharding import (
        shard_embedder_mesh as port_shard,
    )

    tree, tok = tiny_tree
    model = bert.from_hf_state_dict(convert.from_jax_params(
        tree, pc.TEST_TINY), pc.TEST_TINY, device="cpu")
    emb = TorchEmbedder("test-tiny", model=model, config=pc.TEST_TINY,
                        tokenizer=tok, max_tokens=32, device="cpu")
    if dp:
        port_shard(emb, pm(dp=dp, tp=tp, sp=sp, devices=CPUS))
    return emb


def _pair(tiny_tree, dp=4, tp=2, sp=1, plan=None, **kw):
    """(reference manager, port manager), each over its own mesh
    embedder, with the same ``DEVICE_FAULT_PLAN`` spec."""
    ref = _ref_tiny(tiny_tree, dp, tp, sp)
    port = _port_tiny(tiny_tree, dp, tp, sp)
    ref_mgr = ref_res.MeshFaultManager(
        ref, shape=(dp, tp), fault_plan=(
            ref_res.DeviceFaultPlan.parse(plan) if plan else None), **kw)
    mgr = res.MeshFaultManager(
        port, shape=(dp, tp), fault_plan=(
            res.DeviceFaultPlan.parse(plan) if plan else None), **kw)
    assert mgr.build_ladder() == ref_mgr.build_ladder()
    return ref_mgr, mgr


def _clean(tiny_tree, texts=LADDER_TEXTS):
    """The one-device reference answer."""
    return np.asarray(_ref_tiny(tiny_tree, 0, 0).consensus_confidence(texts))


@pytest.mark.parametrize("dp,tp,sp,ladder", [
    (8, 1, 1, [(8, 1), (4, 1), (2, 1), (1, 1)]),
    (4, 2, 1, [(4, 2), (2, 2), (1, 2)]),
    (2, 2, 2, [(2, 2), (1, 2)]),
], ids=["8x1", "4x2", "2x2x2"])
def test_the_ladder_walks_as_the_references(tiny_tree, dp, tp, sp, ladder):
    """dp halves toward 1 with tp and sp kept, every rung a row-major
    prefix of the full device list; rungs, epochs, the faulted domain and
    the snapshot follow the reference step by step, and past the last
    rung both refuse."""
    ref_mgr, mgr = _pair(tiny_tree, dp, tp, sp)
    assert mgr.build_ladder() == ladder
    port = mgr.embedder
    full = port.mesh.flat()
    for want in ladder[1:]:
        assert mgr.downsize() is ref_mgr.downsize() is True
        assert mgr.current_shape == ref_mgr.current_shape == want
        assert port.mesh_shape == ref_mgr.embedder.mesh_shape == want
        assert port.mesh.flat() == full[: want[0] * want[1] * sp]
        assert port.mesh_sp == sp
        assert mgr.snapshot() == ref_mgr.snapshot()
    assert mgr.exhausted and ref_mgr.exhausted
    assert mgr.downsize() is ref_mgr.downsize() is False
    snap = mgr.snapshot()
    assert snap == ref_mgr.snapshot()
    assert len(snap["faulted_devices"]) == dp * tp * sp - tp * sp


def test_warm_ladder_covers_every_rung(tiny_tree):
    ref_mgr, mgr = _pair(tiny_tree)
    got = mgr.warm_ladder([(LN, LS)], [LR], [(4, 64, 8)])
    want = ref_mgr.warm_ladder([(LN, LS)], [LR], [(4, 64, 8)])
    # 4 buckets (vote1, embed, many, packed) x 3 rungs
    assert len(got) == len(want) == 12
    port = mgr.embedder
    assert port.aot_mesh_shapes() == ref_mgr.embedder.aot_mesh_shapes() == [
        (4, 2), (2, 2), (1, 2)]
    # the embedder leaves placed on the full rung, every rung's model kept
    assert port.mesh_shape == (4, 2)
    assert port.mesh_model is mgr._rungs[0].placed
    assert all(r.placed is not None for r in mgr._rungs)
    assert set(mgr.rung_pool_bytes) == {(4, 2), (2, 2), (1, 2)}
    # warming again warms nothing
    assert mgr.warm_ladder([(LN, LS)], [LR], [(4, 64, 8)]) == []


def test_a_downsized_rung_serves_from_its_warmed_buckets(tiny_tree):
    """A switch builds nothing and captures nothing: after the warmup
    every rung's dispatch is at a warmed bucket (0 eager dispatches), on
    the rung's stored model, and answers as the reference's rung."""
    ref_mgr, mgr = _pair(tiny_tree)
    mgr.warm_ladder([(LN, LS)], [LR])
    ref_mgr.warm_ladder([(LN, LS)], [LR])
    port, ref = mgr.embedder, ref_mgr.embedder
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 512, (LN, LS)).astype(np.int32)
    mask = np.ones((LN, LS), np.int32)
    placed = [r.placed for r in mgr._rungs]
    stats0 = port.graph_stats()
    for rung in range(3):
        got = port.consensus_confidence_tokens(ids, mask)
        want = np.asarray(ref.consensus_confidence_tokens(ids, mask))
        np.testing.assert_allclose(got, want, atol=TOL)
        assert port.mesh_model is placed[rung]
        if rung < 2:
            assert mgr.downsize() is ref_mgr.downsize() is True
    stats = port.graph_stats()
    assert stats["eager_dispatches"] == stats0["eager_dispatches"] == 0
    assert stats["captures"] == stats0["captures"]
    assert [r.placed for r in mgr._rungs] == placed


def test_a_transition_waits_for_the_dispatch_in_flight(tiny_tree):
    _, mgr = _pair(tiny_tree)
    dispatching, finish = threading.Event(), threading.Event()
    order = []

    def dispatch():
        with mgr.dispatch_guard():
            dispatching.set()
            finish.wait(5.0)
            order.append("dispatch")

    def downsize():
        mgr.downsize()
        order.append("downsize")

    t = threading.Thread(target=dispatch)
    t.start()
    assert dispatching.wait(5.0)
    w = threading.Thread(target=downsize)
    w.start()
    time.sleep(0.05)
    assert order == [] and mgr.current_shape == (4, 2)
    finish.set()
    t.join(5.0)
    w.join(5.0)
    assert order == ["dispatch", "downsize"]
    assert mgr.current_shape == (2, 2)


def test_a_stale_epoch_does_not_step_the_ladder(tiny_tree):
    ref_mgr, mgr = _pair(tiny_tree)
    for m in (mgr, ref_mgr):
        epoch0 = m.epoch
        assert m.downsize(observed_epoch=epoch0) is True
        assert m.downsize(observed_epoch=epoch0) is True
        assert m.current_shape == (2, 2)
    snap = mgr.snapshot()
    assert snap == ref_mgr.snapshot()
    assert snap["downsizes"] == 1 and snap["epoch"] == 1


def _ref_drive(ref_mgr, batches, **kw):
    batcher = RefBatcher(ref_mgr.embedder, RefMetrics(), meshfault=ref_mgr,
                         **kw)

    async def run():
        return await asyncio.gather(*(batcher.consensus(t) for t in batches))

    return asyncio.run(run()), batcher


def _port_drive(mgr, batches, **kw):
    with DeviceBatcher(mgr.embedder, Metrics(), meshfault=mgr, **kw) as b:
        futures = [b.submit_consensus(t) for t in batches]
        return [f.result(60) for f in futures], b


def test_concurrent_persistent_faults_downsize_once(tiny_tree):
    """Two pipelined groups drawing persistent faults from one fault
    event step the ladder once, and every re-dispatched answer is the
    clean one."""
    short = LADDER_TEXTS[:4]
    ref_mgr, mgr = _pair(tiny_tree, plan="script=persistent|persistent")
    mgr.warm_ladder(WARM, [LR])
    ref_mgr.warm_ladder(WARM, [LR])
    # both groups in flight before either faults, as two dispatches on a
    # dead device are (the reference's loop launches both before either
    # handler runs; the port's two dispatch threads meet here)
    both = threading.Barrier(2, timeout=10)
    draw = mgr.maybe_inject

    def in_flight():
        both.wait()
        draw()

    mgr.maybe_inject = in_flight
    got, _ = _port_drive(mgr, [LADDER_TEXTS, short], window_ms=20.0,
                         pipeline_depth=2)
    want, _ = _ref_drive(ref_mgr, [LADDER_TEXTS, short], window_ms=20.0,
                         pipeline_depth=2)
    for (conf, tok), (rconf, rtok), texts in zip(got, want,
                                                 [LADDER_TEXTS, short]):
        np.testing.assert_allclose(conf, np.asarray(rconf), atol=TOL)
        np.testing.assert_allclose(conf, _clean(tiny_tree, texts), atol=TOL)
        assert tok == rtok
    snap, ref_snap = mgr.snapshot(), ref_mgr.snapshot()
    assert snap["downsizes"] == ref_snap["downsizes"] == 1
    assert snap["current_shape"] == ref_snap["current_shape"] == [2, 2]
    assert snap["re_dispatches"] >= 2 and ref_snap["re_dispatches"] >= 2
    assert mgr.embedder.graph_stats()["eager_dispatches"] == 0


def test_a_persistent_fault_matches_the_clean_run(tiny_tree):
    ref_mgr, mgr = _pair(tiny_tree, plan="script=persistent")
    mgr.warm_ladder(WARM, [LR])
    ref_mgr.warm_ladder(WARM, [LR])
    batches = [LADDER_TEXTS, list(reversed(LADDER_TEXTS))]
    got, _ = _port_drive(mgr, batches, window_ms=20.0)
    want, _ = _ref_drive(ref_mgr, batches, window_ms=20.0)
    for (conf, tok), (rconf, rtok), texts in zip(got, want, batches):
        np.testing.assert_allclose(conf, np.asarray(rconf), atol=TOL)
        np.testing.assert_allclose(conf, _clean(tiny_tree, texts), atol=TOL)
        assert tok == rtok
    assert mgr.snapshot() == ref_mgr.snapshot()
    assert mgr.snapshot()["downsizes"] == 1 and mgr.degraded


def test_a_spent_ladder_switches_to_the_cpu_twin(tiny_tree):
    ref_mgr, mgr = _pair(tiny_tree, dp=2, tp=1,
                         plan="script=persistent|persistent")
    ref_twin, twin = _ref_tiny(tiny_tree, 0, 0), _port_tiny(tiny_tree, 0, 0)
    twin.label_suffix = "@cpu"
    got, b = _port_drive(mgr, [LADDER_TEXTS], window_ms=10.0,
                         fallback_embedder=twin)
    want, rb = _ref_drive(ref_mgr, [LADDER_TEXTS], window_ms=10.0,
                          fallback_embedder=ref_twin)
    np.testing.assert_allclose(got[0][0], np.asarray(want[0][0]), atol=TOL)
    assert mgr.exhausted and ref_mgr.exhausted
    assert b.fallback_active and rb._use_fallback is True
    assert mgr.snapshot() == ref_mgr.snapshot()


def test_a_downsize_rescales_admission_and_the_batcher(tiny_tree):
    from llm_weighted_consensus_tpu_torch.resilience.admission import (
        AdmissionConfig,
        AdmissionController,
    )

    ref_mgr, mgr = _pair(tiny_tree)
    pairs = []
    for m, adm_mod, batcher_cls, metrics in (
            (mgr, (AdmissionConfig, AdmissionController), DeviceBatcher,
             Metrics),
            (ref_mgr, (ref_res.AdmissionConfig, ref_res.AdmissionController),
             RefBatcher, RefMetrics)):
        admission = adm_mod[1](adm_mod[0](max_inflight=16, adaptive=True,
                                          min_limit=2))
        batcher = batcher_cls(m.embedder, metrics(), window_ms=5.0,
                              max_batch=32, max_rows=64)
        m.rescale_hooks.append(admission.rescale)
        m.rescale_hooks.append(batcher.rescale_capacity)
        pairs.append((admission, batcher))
    (adm, b), (radm, rb) = pairs
    try:
        for step, want in ((mgr.downsize, (0.5, 8.0, 16, 32)),
                           (mgr.downsize, (0.25, 4.0, 8, 16))):
            assert step() is True
            scale, limit, batch, rows = want
            assert adm.snapshot()["mesh_scale"] == scale
            assert (adm.limit, b.max_batch, b.max_rows) == (limit, batch,
                                                            rows)
        for _ in range(2):
            assert ref_mgr.downsize() is True
        assert adm.snapshot() == radm.snapshot()
        assert (b.max_batch, b.max_rows) == (rb.max_batch, rb.max_rows)
        # the scaled cap sheds at a quarter of the configured bound
        adm.inflight = radm.inflight = 4
        assert adm.try_acquire() == radm.try_acquire() == "inflight_limit"
        assert mgr.try_recover() is ref_mgr.try_recover() is True
        assert "mesh_scale" not in adm.snapshot()
        assert adm.snapshot() == radm.snapshot()
        assert (b.max_batch, b.max_rows) == (rb.max_batch, rb.max_rows) == (
            32, 64)
        adm.inflight = radm.inflight = 4
        assert adm.try_acquire() is radm.try_acquire() is None
    finally:
        b.close()


def test_the_upsize_returns_to_the_full_rung_and_the_clean_answer(tiny_tree):
    ref_mgr, mgr = _pair(tiny_tree)
    mgr.warm_ladder(WARM, [LR])
    ref_mgr.warm_ladder(WARM, [LR])
    full = mgr.embedder.mesh_model
    for m in (mgr, ref_mgr):
        assert m.downsize() is True
        epoch = m.epoch
        assert m.try_recover() is True
        assert m.current_shape == (4, 2) and not m.degraded
        assert m.epoch == epoch + 1
    assert mgr.embedder.mesh_model is full
    assert mgr.snapshot() == ref_mgr.snapshot()
    assert mgr.snapshot()["upsizes"] == 1
    got, _ = _port_drive(mgr, [LADDER_TEXTS], window_ms=10.0)
    np.testing.assert_allclose(got[0][0], _clean(tiny_tree), atol=TOL)
    assert mgr.embedder.graph_stats()["eager_dispatches"] == 0


def test_recovery_holds_while_the_plan_still_faults(tiny_tree):
    ref_mgr, mgr = _pair(tiny_tree, plan="script=persistent|ok")
    for m in (mgr, ref_mgr):
        assert m.downsize() is True  # a downsize draws nothing
        assert m.try_recover() is False and m.degraded
        assert m.snapshot()["probe_failures"] == 1
    assert mgr.snapshot() == ref_mgr.snapshot()
    assert mgr.try_recover() is ref_mgr.try_recover() is True
    assert not mgr.degraded
    assert mgr.snapshot() == ref_mgr.snapshot()


def test_a_failed_probe_rolls_the_upsize_back(tiny_tree):
    ref_mgr, mgr = _pair(tiny_tree)
    for m, err in ((mgr, res.InjectedPersistentError),
                   (ref_mgr, ref_res.InjectedPersistentError)):
        assert m.downsize() is True

        def bad_probe(err=err):
            raise err("still dead")

        m.probe_fn = bad_probe
        assert m.try_recover() is False and m.degraded
        assert m.embedder.mesh_shape == (2, 2)
    assert mgr.embedder.mesh_model is mgr._rungs[1].placed
    assert mgr.snapshot() == ref_mgr.snapshot()
    assert mgr.snapshot()["probe_failures"] == 1


def test_the_probe_backoff_doubles_and_resets(tiny_tree):
    ref_mgr, mgr = _pair(tiny_tree,
                         plan="script=persistent|persistent|ok")
    for m in (mgr, ref_mgr):
        assert m.downsize() is True
        scales = [m.probe_backoff_scale()]
        for want in (False, False, True):
            assert m.try_recover() is want
            scales.append(m.probe_backoff_scale())
        assert scales == [1.0, 2.0, 4.0, 1.0]
    assert mgr.snapshot() == ref_mgr.snapshot()


def test_a_blind_upsize_warns_once(tiny_tree, caplog):
    import logging

    _, mgr = _pair(tiny_tree)
    assert mgr.downsize() is True
    with caplog.at_level(logging.WARNING, logger="lwc.torch.resilience"):
        assert mgr.try_recover() is True
        assert mgr.downsize() is True
        assert mgr.try_recover() is True
    assert len([r for r in caplog.records
                if "no probe_fn" in r.getMessage()]) == 1


def test_the_ring_mesh_ladder_keeps_sp_and_serves_warmed(tiny_tree):
    """An sp mesh's ladder keeps sp on every rung: its ring buckets are
    warmed per rung, and a downsized rung's ring dispatch answers as the
    reference's."""
    ref_mgr, mgr = _pair(tiny_tree, dp=2, tp=2, sp=2)
    mgr.warm_ladder([], ring_buckets=[(2, 64)])
    ref_mgr.warm_ladder([], ring_buckets=[(2, 64)])
    port, ref = mgr.embedder, ref_mgr.embedder
    assert mgr.downsize() is ref_mgr.downsize() is True
    assert port.mesh_sp == 2 and port.mesh.shape == {"dp": 1, "tp": 2,
                                                     "sp": 2}
    assert port.has_ring_bucket(("ring_vote", 2, 64))
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 512, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)
    got = port.consensus_confidence_tokens_ring(ids, mask)
    want = np.asarray(ref.consensus_confidence_tokens_ring(ids, mask))
    np.testing.assert_allclose(got, want, atol=TOL)
    assert port.graph_stats()["eager_dispatches"] == 0
    assert mgr.snapshot() == ref_mgr.snapshot()


def test_the_mid_traffic_drill_downsizes_once_and_recovers(tiny_tree):
    """The reference's acceptance drill on the port: a persistent fault
    mid-traffic costs one downsize and no request error, ``/readyz``
    stays 200 with ``degraded_mesh`` until the upsize, and every answer
    is the clean one."""
    from llm_weighted_consensus_tpu_torch.serve.lifecycle import Lifecycle

    ref_mgr, mgr = _pair(tiny_tree, plan="script=ok|persistent")
    mgr.warm_ladder(WARM, [LR])
    metrics = Metrics()
    metrics.register_provider("meshfault", mgr.snapshot)
    expect = _clean(tiny_tree)
    with DeviceBatcher(mgr.embedder, metrics, window_ms=15.0,
                       meshfault=mgr) as b:
        life = Lifecycle(batcher=b, meshfault=mgr)
        assert life.readyz() == (200, {"ready": True})
        for _ in range(2):
            futures = [b.submit_consensus(LADDER_TEXTS) for _ in range(2)]
            for f in futures:
                np.testing.assert_allclose(f.result(60)[0], expect,
                                           atol=TOL)
        snap = metrics.snapshot()["meshfault"]
        assert snap["downsizes"] == 1 and snap["current_shape"] == [2, 2]
        assert snap["fault_plan"]["injected"] == {"persistent": 1}
        assert life.readyz() == (200, {"ready": True, "degraded_mesh": True,
                                       "mesh_shape": [2, 2]})
        assert mgr.try_recover() is True
        assert life.readyz() == (200, {"ready": True})
        np.testing.assert_allclose(b.consensus(LADDER_TEXTS)[0], expect,
                                   atol=TOL)
    assert metrics.snapshot()["meshfault"]["upsizes"] == 1
    assert mgr.embedder.graph_stats()["eager_dispatches"] == 0


def test_build_server_warms_the_ladder_and_wires_the_hooks(tiny_tree):
    """The server's manager takes the embedder's mesh shape, warms every
    rung with the ``WARMUP`` buckets, probes the full shape and rescales
    admission and the batcher on a downsize."""
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_server,
        warm_up,
    )

    port = _port_tiny(tiny_tree, 4, 2)
    config = ServeConfig.from_env({
        **MESH, "MESH_SHAPE": "4x2", "MESH_FAULT_ENABLED": "1",
        "WARMUP": f"{LN}x{LS}", "WARMUP_R": str(LR),
        "ADMISSION_MAX_INFLIGHT": "16", "MEMGUARD": "0"})
    srv = build_server(port, None, config)
    try:
        mgr = srv.meshfault
        assert mgr.full_shape == (4, 2)
        assert mgr.build_ladder() == [(4, 2), (2, 2), (1, 2)]
        warm_up(srv, config)
        assert port.aot_mesh_shapes() == [(4, 2), (2, 2), (1, 2)]
        assert srv.lifecycle.ready() == (True, None)
        assert mgr.downsize() is True
        assert srv.batcher.max_batch == srv.batcher._base_max_batch // 2
        assert srv.admission.snapshot()["mesh_scale"] == 0.5
        assert mgr.try_recover() is True  # the probe on the full rung
        assert port.graph_stats()["eager_dispatches"] == 0
        assert "mesh_scale" not in srv.admission.snapshot()
    finally:
        srv.close()
