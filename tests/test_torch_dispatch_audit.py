"""The dispatch audit's CPU half (``analysis/dispatch_audit.py``): clean on
the serving path, and each injected regression named by its rule.

* the served kinds at ``test-tiny`` (full precision, ``int8``,
  ``int4-pallas``) audit clean: no host sync, no int8 dequant, no f64
  outside the kernel wrappers, six quantized-matmul wrapper calls per
  layer, every warmed bucket recorded, no eager dispatch after warmup;
* an injected ``.item()`` is TXA001, a float64 cast TXA003, an int8
  weight dequantized before a float matmul TXA002, a bucket left out of
  warmup TXA004, and a dispatch at an unwarmed bucket TXA005;
* the wrappers' plain versions are out of scope: the plain GEMMs' f64
  accumulation is inside ``w8a8_matmul`` / ``w4a8_matmul`` and is not
  reported;
* the card half refuses to run without a card, with one clear error.
"""

import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu_torch.analysis import dispatch_audit as da
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder

SPECS = ((4, 16),)
R_BUCKETS = (2,)
PACKED = ((1, 64, 8),)


def _embedder(quantize="none"):
    return TorchEmbedder("test-tiny", device="cpu", seed=0,
                         quantize=quantize)


def _rules(findings):
    return sorted({f.rule for f in findings})


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.inference_mode():
        yield


def test_serving_path_audits_clean():
    assert da.run_dispatch_audit() == []


@pytest.mark.parametrize("mode", ["int8", "int4-pallas"])
def test_quantized_forward_audits_clean_with_six_matmuls_a_layer(mode):
    emb = _embedder(mode)
    emb.warmup(list(SPECS))
    ids = np.ones((4, 16), np.int32)
    with da.recording() as rec:
        emb.consensus_confidence_tokens(ids, ids, 0.05)
    calls = rec.wrapper_calls
    wrapper = "w4a8_matmul" if mode == "int4-pallas" else "w8a8_matmul"
    assert calls[wrapper] == 6 * emb.config.num_layers
    assert calls["attention"] == emb.config.num_layers
    assert calls["cosine_vote"] == 1
    assert da.judge(rec, "x", "y", quantized=True,
                    layers=emb.config.num_layers) == []
    # the plain GEMMs' exact f64 accumulation is inside the wrapper
    inside = [op for op in rec.ops if op.in_wrapper
              and torch.float64 in op.in_dtypes + op.out_dtypes]
    assert inside


def test_injected_item_is_txa001():
    emb = _embedder()
    forward = emb._forward

    def syncing(ids, mask):
        out = forward(ids, mask)
        out.sum().item()
        return out

    emb._forward = syncing
    findings = da.audit_embedder(emb, SPECS, (), (),
                                 kinds=("consensus_confidence_tokens",))
    assert _rules(findings) == ["TXA001"]
    assert "aten.item" in findings[0].message
    assert findings[0].path == "dispatch:vote1(n=4,s=16)"


def test_injected_float64_cast_is_txa003():
    emb = _embedder()
    forward = emb._forward
    emb._forward = lambda ids, mask: forward(ids, mask).double().float()
    findings = da.audit_embedder(emb, SPECS, (), (),
                                 kinds=("embed_tokens",))
    assert _rules(findings) == ["TXA003"]


def test_injected_int8_dequant_is_txa002():
    from llm_weighted_consensus_tpu_torch.models.quant import QuantLinear

    emb = _embedder("int8")
    victim = next(m for m in emb.model.modules()
                  if isinstance(m, QuantLinear))

    def dequant_forward(x, gelu=False):
        w = victim.weight_q.float() * victim.scale[:, None]
        out = x.float() @ w.t() + victim.bias
        return out.to(x.dtype)

    victim.forward = dequant_forward
    findings = da.audit_embedder(emb, SPECS, (), (),
                                 kinds=("consensus_confidence_tokens",))
    assert _rules(findings) == ["TXA002"]
    messages = " ".join(f.message for f in findings)
    assert "int8/uint8 tensor to a float type" in messages
    assert "want 12" in messages  # 11 wrapper calls left of 6 x 2 layers


def test_missing_bucket_is_txa004():
    emb = _embedder()
    emb.warmup([(4, 16)])
    findings = da.audit_embedder(emb, ((4, 16), (8, 16)), (), (),
                                 kinds=(), warm=False)
    assert _rules(findings) == ["TXA004"]
    # N=8 pads to the embed bucket of N=4 (16 rows), already warmed
    assert {f.path for f in findings} == {"dispatch:vote1(8,16)"}


def test_dispatch_at_an_unwarmed_bucket_is_txa005():
    emb = _embedder()
    emb.warmup([(4, 16)])
    # audit a spec that was never warmed, without warming it: TXA004 for
    # its keys and TXA005 for each of its dispatches
    findings = da.audit_embedder(emb, ((2, 16),), (), (), warm=False)
    assert _rules(findings) == ["TXA004", "TXA005"]
    txa005 = [f for f in findings if f.rule == "TXA005"]
    # N=2 embeds in the warmed 16-row embed bucket: only the vote is eager
    assert {f.symbol for f in txa005} == {"consensus_confidence_tokens"}
    assert all("1 eager dispatch" in f.message for f in txa005)


def test_served_kinds_cover_the_buckets():
    emb = _embedder()
    calls = da.served_calls(emb, SPECS, R_BUCKETS, PACKED)
    assert [symbol for _, symbol, _ in calls] == [
        "consensus_confidence_tokens", "embed_tokens",
        "consensus_confidence_tokens_many", "embed_packed"]
    assert da.expected_keys(emb, SPECS, R_BUCKETS, PACKED) == [
        ("vote1", 4, 16), ("embed", 16, 16), ("many", 2, 4, 16),
        ("packed", 1, 64, 8)]


def test_env_knobs_under_the_references_names(monkeypatch):
    monkeypatch.setenv("ANALYSIS_JAXPR_SPECS", "2x16, 8x32")
    monkeypatch.setenv("ANALYSIS_JAXPR_R_BUCKETS", "2,4")
    monkeypatch.setenv("ANALYSIS_JAXPR_PACKED_BUCKETS", "")
    assert da._env_specs() == ((2, 16), (8, 32))
    assert da._env_r_buckets() == (2, 4)
    assert da._env_packed_buckets() == ()


def test_card_half_needs_a_card():
    emb = _embedder()
    with pytest.raises(RuntimeError, match="CUDA device"):
        da.card_audit(emb, [], [], {}, device="cpu")
