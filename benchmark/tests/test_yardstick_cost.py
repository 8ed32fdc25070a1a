"""The frozen FLOP counts."""

import pytest
import yardstick_helpers as h

from benchmark import cost, spec


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
