"""The control: the program with the path its configuration's family
names (``control``; for BERT the port's int8 path, W8A8 in every dense
layer of the encoder) switched on, the precision under the bf16 the
configuration states, read by the same comparison as the program.

On the card, at the cell's own size, it has to come out not correct
under the cell's limit while the program comes out correct
(``calibrate.py`` reads both over many seeds; this test reads one).  On
the CPU, at a size a test run holds, its reading has to lie above the
program's: at that size the margin is narrower than the card's, so the
cell's limit is not applied there."""

import pytest
import yardstick_helpers as h

from benchmark import spec

MID = {"hidden_size": 256, "num_hidden_layers": 6, "num_attention_heads": 4,
       "intermediate_size": 1024}


def reading(out):
    return out["checks"]["score_rel_rms"]["value"]


def test_control_reads_above_the_program_on_the_cpu():
    cfg = h.cell(h.COSINE).cfg
    program = h.run(h.cell(h.COSINE, candidates=8, clients=2,
                           dtype="bfloat16", **MID), seed=21, seconds=3.0)
    control = h.run(h.cell(h.COSINE, candidates=8, clients=2,
                           dtype="bfloat16", **MID), seed=21, seconds=3.0,
                    quantize=spec.family(cfg["family"]).control(cfg))
    assert program["correct"]
    assert reading(control) > 2 * reading(program)


@pytest.mark.parametrize("name", [h.COSINE, h.LATENCY, h.LONG])
def test_control_fails_at_the_cells_size_on_the_card(name):
    import time

    import torch

    from benchmark.cell import run_cell

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    cfg = spec.Spec(h.ROOT).cell(name).cfg
    control = spec.family(cfg["family"]).control(cfg)
    outs = {}
    for quantize in ("none", control):
        cell = spec.Spec(h.ROOT).cell(name)
        outs[quantize] = run_cell(cell, 4242, 4.0, False, "cuda",
                                  time.time(), quantize=quantize,
                                  log=lambda m: None)
    assert outs["none"]["correct"], outs["none"]["checks"]
    assert not outs[control]["correct"], outs[control]["checks"]
