"""The benchmark of ``llm_weighted_consensus_tpu_torch``: one cell per
run, ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` (see ``README.md``)."""
