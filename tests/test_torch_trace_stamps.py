"""The tracer checks of the card runs, on synthetic Chrome traces here:
``analysis.trace_stamps`` (stamp offsets, the no-card record) and
``chip_smoke.trace_kernels`` (a capture's second burst matched to its own
launch calls)."""

import json

import pytest

import chip_smoke
from llm_weighted_consensus_tpu_torch.analysis import trace_stamps

ATTN = "void (anonymous namespace)::attention_tma_kernel<false>(int)"
VOTE = "void (anonymous namespace)::cosine_vote_cluster_kernel<float>(int)"


def _write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _call(ts, corr, name="cudaGraphLaunch"):
    return {"cat": "cuda_runtime", "name": name, "ts": ts,
            "args": {"correlation": corr}}


def _kernel(ts, corr, name=ATTN):
    return {"cat": "kernel", "name": name, "ts": ts,
            "args": {"correlation": corr}}


def _two_bursts():
    """Two bursts of one graph replay (two attentions, one other kernel)
    and one vote each; the first burst lost a record, and one kernel of
    the second is stamped before its own launch call."""
    return [
        _call(100.0, 1), _kernel(101.0, 1), _kernel(102.0, 1, "gemm"),
        _call(150.0, 2, "cudaLaunchKernelExC"), _kernel(151.0, 2, VOTE),
        _call(200.0, 3), _kernel(195.0, 3), _kernel(201.0, 3),
        _kernel(202.0, 3, "gemm"),
        _call(250.0, 4, "cudaLaunchKernelExC"), _kernel(251.0, 4, VOTE),
    ]


def test_stamp_offsets_pair_each_kernel_with_its_launch_call(tmp_path):
    events = _two_bursts() + [_kernel(300.0, 99)]  # its call not traced
    out = trace_stamps.stamp_offsets(_write(tmp_path, events))
    assert out["kernels"] == 8
    assert sorted(out["offsets_us"]) == [-5.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0]


def test_trace_stamps_without_a_card_prints_one_error_record(capsys):
    assert trace_stamps.main() == 2
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(line) for line in lines] == [
        {"error": "no-cuda-device"}]


@pytest.mark.parametrize("skip, want", [
    (0, {"attention_tma_kernel<false>": 3, "cosine_vote_cluster_kernel": 2,
         "kernels": 7, "cudaGraphLaunch": 2, "skipped_kernels": 0}),
    (1, {"attention_tma_kernel<false>": 2, "cosine_vote_cluster_kernel": 1,
         "kernels": 4, "cudaGraphLaunch": 1, "skipped_kernels": 3}),
    (2, {"attention_tma_kernel<false>": 0, "cosine_vote_cluster_kernel": 0,
         "kernels": 0, "cudaGraphLaunch": 0, "skipped_kernels": 7}),
])
def test_trace_kernels_counts_the_launches_from_the_cut_on(tmp_path, skip,
                                                            want):
    path = _write(tmp_path, _two_bursts())
    assert chip_smoke.trace_kernels(path, skip) == want
