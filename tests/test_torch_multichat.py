"""The port's multichat client and streaming consensus against the JAX
package's.

* ``generator_slots``, the fan-out and its unary fold, slot-error
  isolation and the per-slot seed offset, on the same scripted upstream
  (``tests/fakes.py`` scripts; the port's client through a port
  ``Transport``): equal JSON once the response id and timestamp are
  masked, exact;
* the streaming consensus on the committed ``tests/fixtures/bge_micro``
  snapshot in f32: the reference's ``StreamingSelfConsistency`` (the JAX
  embedder) against the port's (device tensors, the vote with a count
  per stream) over one arrival order of 20 candidates, every update
  within 1e-5 (f32 encoders summing in different orders), growth past
  the initial capacity of 16 included;
* a failed update leaves no phantom slot, also when it fails after the
  vector was written into the buffer: the count, not the buffer, decides
  what is live;
* ``stream_vote_update_many`` against the reference's, 1e-5;
* the batcher's ``stream`` kind groups R concurrent streams' updates into
  one dispatch whose answers equal R single updates (1e-6: the same
  kernels on the same rows).
"""

import asyncio
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu import registry as ref_registry
from llm_weighted_consensus_tpu.clients import chat as ref_chat
from llm_weighted_consensus_tpu.clients import multichat as ref_mc
from llm_weighted_consensus_tpu.identity.model import ModelBase as RefModelBase
from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.models import loading as jax_loading
from llm_weighted_consensus_tpu.models import tokenizer as jax_tokenizer
from llm_weighted_consensus_tpu.models.embedder import TpuEmbedder
from llm_weighted_consensus_tpu.types import chat_response as ref_cr
from llm_weighted_consensus_tpu.types import multichat_request as ref_mreq
from llm_weighted_consensus_tpu.types import multichat_response as ref_mr
from llm_weighted_consensus_tpu_torch import registry as port_registry
from llm_weighted_consensus_tpu_torch.clients import chat as port_chat
from llm_weighted_consensus_tpu_torch.clients import multichat as port_mc
from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
from llm_weighted_consensus_tpu_torch.models import (
    bert,
    convert,
    loading,
    tokenizer,
)
from llm_weighted_consensus_tpu_torch.models import embedder as port_embedder
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher
from llm_weighted_consensus_tpu_torch.types import chat_response as port_cr
from llm_weighted_consensus_tpu_torch.types import multichat_request as port_mreq
from llm_weighted_consensus_tpu_torch.types import (
    multichat_response as port_mr,
)

from fakes import FakeTransport, Script, chunk_obj
from test_torch_chat_client import PortFakeTransport

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")
TOL = 1e-5


def go(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


# -- the fan-out ----------------------------------------------------------------


def _panel(judges):
    return {"llms": judges}


def _clients(scripts):
    ref_t = FakeTransport([_clone(s) for s in scripts])
    port_t = PortFakeTransport([_clone(s) for s in scripts])
    nr = dict(max_elapsed_ms=0)
    ref = ref_mc.MultichatClient(
        ref_chat.DefaultChatClient(
            ref_t, [ref_chat.ApiBase("https://up.example", "k")],
            backoff=ref_chat.BackoffPolicy(**nr)),
        ref_registry.InMemoryModelRegistry())
    port = port_mc.MultichatClient(
        port_chat.DefaultChatClient(
            port_t, [port_chat.ApiBase("https://up.example", "k")],
            backoff=port_chat.BackoffPolicy(**nr)),
        port_registry.InMemoryModelRegistry())
    return (ref, ref_t), (port, port_t)


def _clone(s):
    return Script(list(s.events), status=s.status, body=s.body,
                  connect_error=s.connect_error, delays=dict(s.delays),
                  done=s.done)


def _masked(obj):
    """A response's JSON with the per-call id and timestamp masked and
    the choices in slot order."""
    obj = dict(obj)
    obj["id"] = obj["id"].split("-")[0]
    obj["created"] = 0
    obj["choices"] = sorted(obj["choices"], key=lambda c: c["index"])
    return obj


def _unary_both(judges, scripts_by_model, **params):
    body = {"messages": [{"role": "user", "content": "answer the question"}],
            "model": _panel(judges), **params}
    model = RefModelBase.from_json_obj(body["model"]).into_model_validate()
    order = [llm.base.model for _, llm in ref_mc.generator_slots(model)]
    (ref, ref_t), (port, port_t) = _clients(
        [scripts_by_model[m] for m in order])
    want = go(ref.create_unary(
        None, ref_mreq.ChatCompletionCreateParams.from_json_obj(body)))
    got = go(port.create_unary(
        None, port_mreq.ChatCompletionCreateParams.from_json_obj(body)))
    return want, got, ref_t, port_t


@pytest.mark.parametrize("seed", range(4))
def test_generator_slots_equal(seed):
    rng = np.random.default_rng(seed)
    judges = [
        {"model": f"gen-{int(rng.integers(0, 3))}",
         "weight": {"type": "static", "weight": int(rng.integers(1, 4))}}
        for _ in range(int(rng.integers(1, 9)))
    ]
    ref = RefModelBase.from_json_obj(_panel(judges)).into_model_validate()
    port = ModelBase.from_json_obj(_panel(judges)).into_model_validate()
    assert [(s, l.multichat_id, l.base.model)
            for s, l in port_mc.generator_slots(port)] == [
        (s, l.multichat_id, l.base.model)
        for s, l in ref_mc.generator_slots(ref)]


def test_fanout_unary_fold_equal():
    want, got, _, _ = _unary_both(
        [{"model": "gen-a"}, {"model": "gen-b"}],
        {"gen-a": Script([chunk_obj("alpha ", model="gen-a"),
                          chunk_obj("answer", model="gen-a", finish="stop")]),
         "gen-b": Script([chunk_obj("beta answer", model="gen-b",
                                    finish="stop")])},
    )
    assert got.id.startswith("mchcpl-")
    assert _masked(got.to_json_obj()) == _masked(want.to_json_obj())


def test_streaming_frames_equal():
    judges = [{"model": "gen-a"}, {"model": "gen-b"}, {"model": "gen-a"}]
    body = {"messages": [{"role": "user", "content": "q"}],
            "model": _panel(judges), "stream": True}
    scripts = [Script([chunk_obj(f"s{i} "), chunk_obj("end", finish="stop")],
                      delays={0: 0.02 * i}) for i in range(3)]
    (ref, _), (port, _) = _clients(scripts)

    async def frames(client, mreq):
        stream = await client.create_streaming(
            None, mreq.ChatCompletionCreateParams.from_json_obj(body))
        return [_masked(c.to_json_obj()) async for c in stream]

    assert go(frames(port, port_mreq)) == go(frames(ref, ref_mreq))


def test_slot_error_isolation_equal():
    want, got, _, _ = _unary_both(
        [{"model": "gen-a"}, {"model": "gen-b"}],
        {"gen-a": Script(status=500, body=b'{"err": 1}'),
         "gen-b": Script([chunk_obj("ok", model="gen-b", finish="stop")])},
    )
    assert _masked(got.to_json_obj()) == _masked(want.to_json_obj())
    errors = [c.error for c in got.choices if c.error is not None]
    assert len(errors) == 1 and errors[0].code == 500


def test_seed_offset_per_slot_equal():
    want, got, ref_t, port_t = _unary_both(
        [{"model": "gen-a"}, {"model": "gen-a"}],
        {"gen-a": Script([chunk_obj("s", finish="stop")])}, seed=100,
    )
    assert sorted(b["seed"] for _, _, b in port_t.requests) == [100, 101]
    assert [b for _, _, b in port_t.requests] == \
        [b for _, _, b in ref_t.requests]


def test_unknown_panel_id_is_the_reference_error():
    body = {"messages": [{"role": "user", "content": "q"}],
            "model": "A" * 22}
    (ref, _), (port, _) = _clients([])
    with pytest.raises(Exception) as want:
        go(ref.create_unary(
            None, ref_mreq.ChatCompletionCreateParams.from_json_obj(body)))
    with pytest.raises(Exception) as got:
        go(port.create_unary(
            None, port_mreq.ChatCompletionCreateParams.from_json_obj(body)))
    assert type(got.value).__name__ == type(want.value).__name__
    assert got.value.status() == want.value.status() == 404
    assert got.value.message() == want.value.message()


# -- the streaming consensus on bge_micro ---------------------------------------


@pytest.fixture(scope="module")
def micro():
    port_cfg = loading.load_hf_config(FIXTURE)
    jax_cfg = jax_configs.BertConfig(
        **{f.name: getattr(port_cfg, f.name)
           for f in dataclasses.fields(port_cfg)}
    )
    params = jax_loading.load_params(FIXTURE, jax_cfg)
    state = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), port_cfg
    )
    vocab = loading.find_vocab(FIXTURE)
    ref = TpuEmbedder("bge-micro", params=params, config=jax_cfg,
                      tokenizer=jax_tokenizer.load_tokenizer(vocab),
                      max_tokens=64)
    port = TorchEmbedder(
        "bge-micro", model=bert.from_hf_state_dict(state, port_cfg,
                                                   device="cpu"),
        config=port_cfg, tokenizer=tokenizer.load_tokenizer(vocab),
        max_tokens=64, device="cpu",
    )
    return ref, port


WORDS = ("paris france capital city river seine banana yellow curved fruit "
         "one two three answer is the of").split()


def _candidates(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(3, 14))))
            for _ in range(n)]


def _finished(mr, cr, slot, text):
    return mr.ChatCompletionChunk(
        id="x", created=0, model="m", usage=None,
        choices=[mr.StreamingChoice(
            delta=cr.Delta(content=text), finish_reason="stop", index=slot,
            logprobs=None, error=None, model="g", model_index=slot,
            completion_metadata=None)],
    )


def _updates(sc, mr, cr, order, texts):
    out = []
    for slot in order:
        out.append(sc.push_chunk(_finished(mr, cr, slot, texts[slot])))
    return out


def _close(want, got):
    assert (want is None) == (got is None)
    if want is None:
        return 0.0
    assert want.keys() == got.keys()
    return max(abs(want[k] - got[k]) for k in want)


def test_streaming_consensus_matches_the_reference_past_capacity(micro):
    ref_emb, port_emb = micro
    texts = _candidates(0, 20)
    order = list(np.random.default_rng(1).permutation(20))
    ref = ref_mc.StreamingSelfConsistency(ref_emb)
    port = port_mc.StreamingSelfConsistency(port_emb)
    want = _updates(ref, ref_mr, ref_cr, order, texts)
    got = _updates(port, port_mr, port_cr, order, texts)
    assert want[0] is None and got[0] is None
    worst = max(_close(w, g) for w, g in zip(want, got))
    assert worst <= TOL, worst
    # 20 candidates: the buffer doubled once, its rows are the vectors
    assert port.count == 20 and tuple(port._buf.shape) == (32, 96)
    assert np.allclose(port._buf[20:].numpy(), 0.0)
    assert abs(sum(got[-1].values()) - 1.0) < 1e-5


def test_failed_update_leaves_no_phantom_slot(micro, monkeypatch):
    """The vote fails after the new vector was written into the buffer:
    the row is there, but the count did not move, and the next update
    writes its own vector at the same position."""
    ref_emb, port_emb = micro
    texts = _candidates(2, 6)
    port = port_mc.StreamingSelfConsistency(port_emb)
    _updates(port, port_mr, port_cr, [0, 1, 2], texts)
    real_vote = port_embedder.cosine_vote
    calls = []

    def failing_vote(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("device fault")

    monkeypatch.setattr(port_embedder, "cosine_vote", failing_vote)
    with pytest.raises(RuntimeError):
        port.push_chunk(_finished(port_mr, port_cr, 5, texts[5]))
    assert calls and port.count == 3 and 5 not in port._order
    # the failed candidate's vector is in row 3, and it is not live
    assert float(port._buf[3].abs().sum()) > 0
    monkeypatch.setattr(port_embedder, "cosine_vote", real_vote)
    # slot 5 finished with an error upstream, so it never retries; the
    # next candidate takes position 3
    port.failed.add(5)
    got = port.push_chunk(_finished(port_mr, port_cr, 3, texts[3]))
    assert port._order == [0, 1, 2, 3]
    ref = ref_mc.StreamingSelfConsistency(ref_emb)
    want = _updates(ref, ref_mr, ref_cr, [0, 1, 2, 3], texts)[-1]
    assert set(got) == {0, 1, 2, 3}
    assert _close(want, got) <= TOL


def test_failed_embed_before_the_write_leaves_no_phantom(micro):
    _, port_emb = micro
    port = port_mc.StreamingSelfConsistency(port_emb)
    texts = _candidates(3, 3)

    def boom(*args, **kwargs):
        raise RuntimeError("device OOM")

    real = port_emb.stream_vote_update
    port_emb.stream_vote_update = boom
    try:
        with pytest.raises(RuntimeError):
            port.push_chunk(_finished(port_mr, port_cr, 0, texts[0]))
    finally:
        port_emb.stream_vote_update = real
    assert port.count == 0 and port.confidence == {}


def test_stream_vote_update_many_matches_the_reference(micro):
    ref_emb, port_emb = micro
    r, cap, hidden = 5, 16, port_emb.config.hidden_size
    rng = np.random.default_rng(4)
    counts = [1, 3, 0, 7, 15]  # live rows per stream before the update
    bufs = np.zeros((r, cap, hidden), np.float32)
    for i, c in enumerate(counts):
        bufs[i, :c] = rng.normal(size=(c, hidden))
    valids = (np.arange(cap)[None, :] < np.array(counts)[:, None])
    texts = _candidates(5, r)
    want_bufs, _, want = ref_emb.stream_vote_update_many(
        texts, [jnp.asarray(b) for b in bufs],
        [jnp.asarray(v.astype(np.float32)) for v in valids], counts, 0.05)
    port_bufs = [torch.from_numpy(b.copy()) for b in bufs]
    got = port_emb.stream_vote_update_many(texts, port_bufs, counts, 0.05)
    assert got.shape == (r, cap)
    assert np.max(np.abs(got - np.asarray(want))) <= TOL
    for i in range(r):
        assert np.max(np.abs(port_bufs[i].numpy()
                             - np.asarray(want_bufs[i]))) <= TOL
    # one stream alone is the grouped answer's row
    single = port_emb.stream_vote_update(
        texts[3], torch.from_numpy(bufs[3].copy()), counts[3], 0.05)
    assert np.max(np.abs(single - got[3])) <= 1e-6


def test_batcher_groups_stream_updates_into_one_dispatch(micro):
    _, port_emb = micro
    r, cap = 4, 16
    texts = _candidates(6, r)
    counts = [2, 0, 5, 9]
    rng = np.random.default_rng(7)
    base = rng.normal(size=(r, cap, port_emb.config.hidden_size)).astype(
        np.float32)
    for i, c in enumerate(counts):
        base[i, c:] = 0.0
    want = [
        port_emb.stream_vote_update(texts[i], torch.from_numpy(base[i].copy()),
                                    counts[i], 0.05)
        for i in range(r)
    ]
    bufs = [torch.from_numpy(base[i].copy()) for i in range(r)]
    with DeviceBatcher(port_emb, window_ms=300.0) as batcher:
        futures = [
            batcher.submit_stream(texts[i], bufs[i], counts[i], 0.05,
                                  want_conf=i != 1)
            for i in range(r)
        ]
        got = [f.result(60) for f in futures]
        stats = batcher.stats()
    assert stats["stream"] == {"dispatches": 1, "requests": r,
                               "largest_group": r}
    assert stats["dispatches"] == {"consensus": 0, "embed": 0}
    assert got[1] is None  # want_conf=False skips the copy back
    for i in (0, 2, 3):
        assert np.max(np.abs(got[i] - want[i])) <= 1e-6
        # the buffer stays where it was and holds the new vector
        assert np.any(bufs[i][counts[i]].numpy() != 0)


def test_async_consensus_through_the_batcher_matches_blocking(micro):
    _, port_emb = micro
    texts = _candidates(8, 5)
    blocking = port_mc.StreamingSelfConsistency(port_emb)
    want = _updates(blocking, port_mr, port_cr, range(5), texts)
    with DeviceBatcher(port_emb, window_ms=1.0) as batcher:
        sc = port_mc.StreamingSelfConsistency(port_emb, batcher=batcher)

        async def run():
            return [
                await sc.push_chunk_async(
                    _finished(port_mr, port_cr, slot, texts[slot]))
                for slot in range(5)
            ]

        got = go(run())
    for w, g in zip(want, got):
        assert _close(w, g) <= 1e-6
