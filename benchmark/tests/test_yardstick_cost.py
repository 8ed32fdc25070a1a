"""The frozen FLOP counts, and the arithmetic of ``mfu_bf16.*`` and
``attn_roofline.*`` pinned for both configurations and their CPU sizes:
the values below were read before the harness loaded a configuration's
family by name, and hold unchanged after."""

import json

import pytest
import yardstick_helpers as h

from benchmark import cost, spec
from benchmark.readings import Readings


def bge():
    return spec.Spec(h.ROOT).cell(h.COSINE).cfg


def test_bge_large_answer_is_5_05_tflop():
    assert cost.flops_per_answer(bge(), 64, 128) == pytest.approx(
        5.0508e12, rel=1e-4)


def test_request_flops_at_the_padded_length_is_flops_per_answer():
    cfg = bge()
    assert cost.request_flops(cfg, [128] * 64) == pytest.approx(
        cost.flops_per_answer(cfg, 64, 128), rel=1e-12)


def test_deberta_adds_its_disentangled_terms():
    import json

    cfg = json.loads(h.RM_CONFIG.read_text())
    h_, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    one = cost.deberta_sequence_flops(cfg, 500)
    assert one - cost.bert_sequence_flops(cfg, 500) == pytest.approx(
        layers * 4 * 500 * 500 * h_ + 2 * h_ * h_ + 2 * h_)
    assert cost.deberta_table_flops(cfg) == layers * 2 * 2 * 512 * h_ * h_


def test_attention_launch_bound_is_the_byte_bound():
    flops, nbytes = cost.attention_launch(512, 128, 16, 64)
    assert flops == 4 * 512 * 128 * 128 * 1024
    assert cost.bound_seconds(flops, nbytes) == pytest.approx(
        nbytes / cost.H100_HBM_BYTES_PER_S)
    assert nbytes / cost.H100_HBM_BYTES_PER_S * 1e3 == pytest.approx(
        0.1603, rel=2e-3)


def pinned_configs() -> dict:
    """The two configurations as run, and each cut to the CPU size."""
    return {"bge-large-en": bge(),
            "deberta-v3-base": json.loads(h.RM_CONFIG.read_text()),
            "bge-large-en.tiny": h.cell(h.COSINE).cfg,
            "deberta-v3-base.tiny": h.cell(h.RM).cfg}


FLOPS = [
    ("bge-large-en", [66, 100, 122], 176820584448.0),
    ("bge-large-en", [258, 482], 476326920192.0),
    ("bge-large-en", [1], 604078080.0),
    ("deberta-v3-base", [66, 100, 122], 65577226752.0),
    ("deberta-v3-base", [258, 482], 162237582336.0),
    ("deberta-v3-base", [1], 14666638848.0),
    ("bge-large-en.tiny", [66, 100, 122], 52719616.0),
    ("bge-large-en.tiny", [258, 482], 250023936.0),
    ("bge-large-en.tiny", [1], 131584.0),
    ("deberta-v3-base.tiny", [66, 100, 122], 84492672.0),
    ("deberta-v3-base.tiny", [258, 482], 419848448.0),
    ("deberta-v3-base.tiny", [1], 16917632.0),
]


@pytest.mark.parametrize("name,lengths,want", FLOPS)
def test_pinned_request_flops(name, lengths, want):
    assert cost.request_flops(pinned_configs()[name], lengths) == want


def roofline(cfg: dict, buckets: dict) -> float:
    """``attn_roofline`` on a synthetic window: ``buckets`` {label:
    dispatches}, one 200 us attention launch per layer per dispatch."""
    count = cfg["num_hidden_layers"] * sum(buckets.values())
    kernels = [("void attention_tma_kernel<false>(CUtensorMap)",
                i * 300_000, i * 300_000 + 200_000) for i in range(count)]
    kernels.append(("nvjet_tst_256x128_64x4", 0, 10_000))
    r = Readings(cfg=cfg, mix={}, window_s=1.0, completed=[],
                 latencies_ms=[], lengths=[],
                 before={"device_buckets": {"vote1(n=64,s=128)": 5}},
                 after={"device_buckets": {k: v + 5 * (
                     k == "vote1(n=64,s=128)") for k, v in buckets.items()}},
                 trace={"kernels": kernels, "device": [], "busy_s": 0.0,
                        "window_s": 1.0},
                 port_kernels={"attention_tma_kernel", "lwc_gelu_kernel"})
    return r.attention_roofline_percent()


R8 = {"many(r=8,n=64,s=128)@graph": 3}
R1 = {"vote1(n=64,s=128)": 4}
LONG = {"vote1(n=32,s=512)": 2}
MIXED = {"many(r=8,n=64,s=128)": 1, "many(r=2,n=64,s=128)": 2,
         "vote1(n=64,s=128)": 3, "embed(b=16,s=128)": 1, "odd": 4}

ROOFLINES = [
    ("bge-large-en", R8, 80.1691128358209),
    ("bge-large-en", R1, 10.021139104477614),
    ("bge-large-en", LONG, 20.042278208955228),
    ("bge-large-en", MIXED, 21.8317673347548),
    ("deberta-v3-base", R8, 60.136616119402994),
    ("deberta-v3-base", R1, 7.517077014925373),
    ("deberta-v3-base", LONG, 15.034154029850747),
    ("bge-large-en.tiny", R8, 5.047250149253732),
    ("bge-large-en.tiny", LONG, 1.2618125373134328),
    ("deberta-v3-base.tiny", R1, 0.6309062686567164),
    ("deberta-v3-base.tiny", LONG, 1.2618125373134328),
]


@pytest.mark.parametrize("name,buckets,want", ROOFLINES)
def test_pinned_attention_roofline(name, buckets, want):
    assert roofline(pinned_configs()[name], buckets) == pytest.approx(
        want, rel=1e-12)


def test_pinned_roofline_reads_nothing_without_launches_or_buckets():
    cfg = bge()
    assert roofline(cfg, {}) is None
    assert roofline(cfg, {"odd": 3}) is None
