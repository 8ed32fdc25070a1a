"""The port's wire types and JSON writer against the JAX package's.

``llm_weighted_consensus_tpu_torch.types`` and ``.utils.jsonutil`` are
the port's own copies of the reference's JAX-free modules.  On recorded
OpenAI-style chunk JSON, request bodies and seeded random streams (numpy
seed), both packages must parse and dump to the same bytes, fold the same
streams to the same unary response, and fail a bad body with the same
JSON-path message.  Exact equality throughout (no tolerance: no float
arithmetic happens here).
"""

import json
from decimal import Decimal

import numpy as np
import pytest

from llm_weighted_consensus_tpu import utils as ref_utils
from llm_weighted_consensus_tpu.types import base as ref_base
from llm_weighted_consensus_tpu.types import chat_request as ref_req
from llm_weighted_consensus_tpu.types import chat_response as ref_cr
from llm_weighted_consensus_tpu.types import multichat_request as ref_mreq
from llm_weighted_consensus_tpu.types import multichat_response as ref_mr
from llm_weighted_consensus_tpu.types import score_request as ref_sreq
from llm_weighted_consensus_tpu.types import score_response as ref_sr
from llm_weighted_consensus_tpu.utils import jsonutil as ref_json
from llm_weighted_consensus_tpu_torch import utils as port_utils
from llm_weighted_consensus_tpu_torch.types import base as port_base
from llm_weighted_consensus_tpu_torch.types import chat_request as port_req
from llm_weighted_consensus_tpu_torch.types import chat_response as port_cr
from llm_weighted_consensus_tpu_torch.types import (
    multichat_request as port_mreq,
)
from llm_weighted_consensus_tpu_torch.types import (
    multichat_response as port_mr,
)
from llm_weighted_consensus_tpu_torch.types import score_request as port_sreq
from llm_weighted_consensus_tpu_torch.types import score_response as port_sr
from llm_weighted_consensus_tpu_torch.utils import jsonutil as port_json

# Chunks as OpenAI-compatible providers send them (OpenAI, OpenRouter with
# provider/cost, reasoning deltas, tool-call fragments, logprobs, the
# usage-only tail of stream_options.include_usage).
RECORDED_CHUNKS = [
    '{"id":"chatcmpl-9x1","object":"chat.completion.chunk","created":1718000000,'
    '"model":"gpt-4o-2024-05-13","system_fingerprint":"fp_43dfabdef1",'
    '"choices":[{"index":0,"delta":{"role":"assistant","content":""},'
    '"logprobs":null,"finish_reason":null}]}',
    '{"id":"chatcmpl-9x1","object":"chat.completion.chunk","created":1718000000,'
    '"model":"gpt-4o-2024-05-13","system_fingerprint":"fp_43dfabdef1",'
    '"choices":[{"index":0,"delta":{"content":"Paris"},"logprobs":{"content":'
    '[{"token":"Paris","logprob":-0.0019,"bytes":[80,97,114,105,115],'
    '"top_logprobs":[{"token":"Paris","logprob":-0.0019,"bytes":[80,97,114,'
    '105,115]},{"token":"The","logprob":-6.25,"bytes":[84,104,101]}]}]},'
    '"finish_reason":null}]}',
    '{"id":"chatcmpl-9x1","object":"chat.completion.chunk","created":1718000000,'
    '"model":"gpt-4o-2024-05-13","choices":[{"index":0,"delta":{},'
    '"logprobs":null,"finish_reason":"stop"}]}',
    '{"id":"chatcmpl-9x1","object":"chat.completion.chunk","created":1718000000,'
    '"model":"gpt-4o-2024-05-13","choices":[],"usage":{"prompt_tokens":19,'
    '"completion_tokens":2,"total_tokens":21,"prompt_tokens_details":'
    '{"cached_tokens":0},"completion_tokens_details":{"reasoning_tokens":0}}}',
    '{"id":"gen-17180-abc","provider":"Fireworks","model":"meta-llama/llama-3-70b",'
    '"object":"chat.completion.chunk","created":1718000100,"choices":[{"index":0,'
    '"delta":{"role":"assistant","content":" capital"},"finish_reason":null,'
    '"native_finish_reason":null,"logprobs":null}]}',
    '{"id":"gen-17180-abc","provider":"Fireworks","model":"meta-llama/llama-3-70b",'
    '"object":"chat.completion.chunk","created":1718000100,"choices":[{"index":0,'
    '"delta":{"role":"assistant","content":""},"finish_reason":"stop",'
    '"native_finish_reason":"stop","logprobs":null}],"usage":{"prompt_tokens":12,'
    '"completion_tokens":9,"total_tokens":21,"cost":0.0000189}}',
    '{"id":"gen-2","object":"chat.completion.chunk","created":1718000200,'
    '"model":"deepseek/deepseek-r1","choices":[{"index":0,"delta":{"role":'
    '"assistant","content":null,"reasoning":"First, recall the map."},'
    '"finish_reason":null}]}',
    '{"id":"chatcmpl-tool","object":"chat.completion.chunk","created":1718000300,'
    '"model":"gpt-4o-mini","choices":[{"index":0,"delta":{"role":"assistant",'
    '"content":null,"tool_calls":[{"index":0,"id":"call_abc","type":"function",'
    '"function":{"name":"lookup","arguments":""}}],"refusal":null},'
    '"logprobs":null,"finish_reason":null}]}',
    '{"id":"chatcmpl-tool","object":"chat.completion.chunk","created":1718000300,'
    '"model":"gpt-4o-mini","choices":[{"index":0,"delta":{"tool_calls":[{"index":0,'
    '"function":{"arguments":"{\\"city\\": \\"Paris\\"}"}}]},"logprobs":null,'
    '"finish_reason":"tool_calls"}]}',
    '{"id":"x","object":"chat.completion.chunk","created":1,"model":"m",'
    '"choices":[{"index":1,"delta":{"content":"caf\\u00e9 \\ud83d\\ude00 \\n\\t"},'
    '"finish_reason":"length"}],"service_tier":"default"}',
]

REQUESTS = [
    (ref_req.ChatCompletionCreateParams, port_req.ChatCompletionCreateParams,
     {"model": "openai/gpt-4o", "messages": [
         {"role": "system", "content": "be brief"},
         {"role": "user", "content": [
             {"type": "text", "text": "what is this?"},
             {"type": "image_url", "image_url": {"url": "https://x/y.png"}}]},
         {"role": "assistant", "content": "a cat", "tool_calls": [
             {"id": "c1", "type": "function",
              "function": {"name": "f", "arguments": "{}"}}]},
         {"role": "tool", "content": "ok", "tool_call_id": "c1"}],
      "temperature": 0.7, "top_p": 0.95, "max_completion_tokens": 64,
      "stop": ["\n\n"], "seed": 7, "stream": True,
      "stream_options": {"include_usage": True},
      "response_format": {"type": "json_schema", "json_schema": {
          "name": "answer", "strict": True, "schema": {
              "type": "object", "properties": {"a": {"type": "string"}}}}},
      "tools": [{"type": "function", "function": {
          "name": "f", "description": "d",
          "parameters": {"type": "object", "properties": {}}}}],
      "provider": {"order": ["OpenAI"], "allow_fallbacks": False},
      "logit_bias": {"50256": -100}, "logprobs": True, "top_logprobs": 3}),
    (ref_mreq.ChatCompletionCreateParams, port_mreq.ChatCompletionCreateParams,
     {"messages": [{"role": "user", "content": "q"}],
      "model": {"llms": [{"model": "a", "weight": {"type": "static",
                                                   "weight": 2.5}},
                         {"model": "b", "temperature": 0.3}]},
      "seed": 1, "stream": True, "consensus": True}),
    (ref_sreq.ChatCompletionCreateParams, port_sreq.ChatCompletionCreateParams,
     {"messages": [{"role": "user", "content": "pick"}],
      "model": "AAAAAAAAAAAAAAAAAAAAAA",
      "choices": ["one", "two", {"type": "chat_completion", "id": "c",
                                 "choice_index": 0}]}),
]

BAD_BODIES = [
    (ref_req.ChatCompletionCreateParams, port_req.ChatCompletionCreateParams,
     {"model": "m"}),
    (ref_req.ChatCompletionCreateParams, port_req.ChatCompletionCreateParams,
     {"model": "m", "messages": [{"role": "robot", "content": "x"}]}),
    (ref_req.ChatCompletionCreateParams, port_req.ChatCompletionCreateParams,
     {"model": "m", "messages": [{"role": "user", "content": 5}]}),
    (ref_req.ChatCompletionCreateParams, port_req.ChatCompletionCreateParams,
     {"model": "m", "messages": [], "temperature": "hot"}),
    (ref_mreq.ChatCompletionCreateParams, port_mreq.ChatCompletionCreateParams,
     {"model": 5, "messages": []}),
    (ref_mreq.ChatCompletionCreateParams, port_mreq.ChatCompletionCreateParams,
     {"model": {"llms": [{"model": 3}]}, "messages": []}),
    (ref_cr.ChatCompletionChunk, port_cr.ChatCompletionChunk,
     {"id": "x", "choices": [{"index": "0", "delta": {}}], "created": 1,
      "model": "m"}),
    (ref_cr.ChatCompletionChunk, port_cr.ChatCompletionChunk, [1, 2]),
]


@pytest.mark.parametrize("raw", RECORDED_CHUNKS)
def test_recorded_chunks_round_trip_to_the_same_bytes(raw):
    ref = ref_cr.ChatCompletionChunk.from_json(raw)
    port = port_cr.ChatCompletionChunk.from_json(raw)
    assert port.to_json() == ref.to_json()
    # a second trip is stable
    assert port_cr.ChatCompletionChunk.from_json(port.to_json()).to_json() \
        == port.to_json()


@pytest.mark.parametrize("case", range(len(REQUESTS)))
def test_request_bodies_round_trip_to_the_same_bytes(case):
    ref_cls, port_cls, body = REQUESTS[case]
    raw = json.dumps(body)
    ref = ref_cls.from_json_obj(ref_json.loads(raw))
    port = port_cls.from_json_obj(port_json.loads(raw))
    assert port.to_json() == ref.to_json()
    assert port.clone().to_json() == ref.clone().to_json()


@pytest.mark.parametrize("case", range(len(BAD_BODIES)))
def test_schema_errors_name_the_same_json_path(case):
    ref_cls, port_cls, body = BAD_BODIES[case]
    with pytest.raises(ValueError) as want:
        ref_cls.from_json_obj(body)
    with pytest.raises(ValueError) as got:
        port_cls.from_json_obj(body)
    assert isinstance(got.value, port_base.SchemaError)
    assert str(got.value) == str(want.value)


def _random_stream(rng, cr, n_chunks: int):
    """A seeded stream over 3 choice indexes: content fragments, a
    reasoning fragment, a finish per choice, usage with a Decimal cost."""
    chunks = []
    for k in range(n_chunks):
        index = int(rng.integers(0, 3))
        word = "".join(rng.choice(list("abcdeé ")) for _ in range(4))
        delta = cr.Delta(
            content=word,
            reasoning=word if rng.random() < 0.2 else None,
        )
        finish = "stop" if k >= n_chunks - 3 else None
        usage = None
        if rng.random() < 0.3:
            usage = cr.Usage(
                completion_tokens=int(rng.integers(0, 9)),
                prompt_tokens=int(rng.integers(0, 9)),
                total_tokens=int(rng.integers(0, 18)),
                cost=Decimal(int(rng.integers(0, 1000))) / Decimal(10000),
            )
        chunks.append(cr.ChatCompletionChunk(
            id="cmpl-r", created=123, model="m",
            choices=[cr.StreamingChoice(delta=delta, finish_reason=finish,
                                        index=index)],
            usage=usage,
        ))
    return chunks


@pytest.mark.parametrize("seed", range(6))
def test_fold_chunks_equal(seed):
    ref = ref_base.fold_chunks(
        _random_stream(np.random.default_rng(seed), ref_cr, 12 + seed))
    port = port_base.fold_chunks(
        _random_stream(np.random.default_rng(seed), port_cr, 12 + seed))
    assert port.to_json() == ref.to_json()
    assert port_cr.ChatCompletion.from_streaming(port).to_json() == \
        ref_cr.ChatCompletion.from_streaming(ref).to_json()


def _multichat_stream(mr, cr, sr, seed: int):
    rng = np.random.default_rng(seed)
    chunks = []
    for k in range(10):
        slot = int(rng.integers(0, 4))
        chunks.append(mr.ChatCompletionChunk(
            id="mchcpl-1", created=5, model="panel",
            choices=[mr.StreamingChoice(
                delta=cr.Delta(content=f"w{k} "),
                finish_reason="stop" if k >= 7 else None,
                index=slot, logprobs=None, error=None,
                model=f"gen{slot}", model_index=slot,
                completion_metadata=sr.CompletionMetadata(
                    id=f"up{slot}", created=1, model=f"g{slot}",
                    usage=cr.Usage(completion_tokens=1, prompt_tokens=2,
                                   total_tokens=3),
                ),
            )],
            usage=None,
        ))
    return chunks


@pytest.mark.parametrize("seed", range(3))
def test_multichat_fold_equal(seed):
    ref = ref_base.fold_chunks(_multichat_stream(ref_mr, ref_cr, ref_sr, seed))
    port = port_base.fold_chunks(
        _multichat_stream(port_mr, port_cr, port_sr, seed))
    assert port.to_json() == ref.to_json()
    ref_unary = ref_mr.ChatCompletion.from_streaming(ref)
    port_unary = port_mr.ChatCompletion.from_streaming(port)
    ref_unary.consensus = {"0": 0.25, "1": 0.75}
    port_unary.consensus = {"0": 0.25, "1": 0.75}
    assert port_unary.to_json() == ref_unary.to_json()


def _random_json(rng, depth=0):
    kind = int(rng.integers(0, 8 if depth < 3 else 5))
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return int(rng.integers(-10**12, 10**12))
    if kind == 3:
        return [float(rng.normal()), Decimal("1.50"), 1e-7, 123456789.0][
            int(rng.integers(0, 4))]
    if kind == 4:
        return "".join(rng.choice(list('ab"\\\n\té€😀/')) for _ in range(5))
    if kind in (5, 6):
        return {f"k{i}": _random_json(rng, depth + 1)
                for i in range(int(rng.integers(0, 4)))}
    return [_random_json(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]


@pytest.mark.parametrize("seed", range(4))
def test_jsonutil_writes_and_reads_the_same(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        obj = _random_json(rng)
        assert port_json.dumps(obj) == ref_json.dumps(obj)
        assert port_json.dumps(obj, pretty=True) == \
            ref_json.dumps(obj, pretty=True)
        text = ref_json.dumps(obj)
        assert port_json.dumps(port_json.loads(text)) == \
            ref_json.dumps(ref_json.loads(text))


def test_response_id_and_choice_indexer():
    rid = port_utils.response_id("mchcpl", 1700000000)
    prefix, hexid, created = rid.split("-")
    assert (prefix, created, len(hexid)) == ("mchcpl", "1700000000", 32)
    ref_ix, port_ix = ref_utils.ChoiceIndexer(4), port_utils.ChoiceIndexer(4)
    keys = [(0, 0), (1, 0), (0, 0), (2, 3), (1, 0), (0, 1)]
    assert [port_ix.get(*k) for k in keys] == [ref_ix.get(*k) for k in keys]
