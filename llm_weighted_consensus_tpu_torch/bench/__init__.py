"""The port's benches: ``python -m
llm_weighted_consensus_tpu_torch.bench <name> [flags]``.

One module per root script of the reference, with its flags and record
keys: ``headline`` (``bench.py``), ``fwd`` (``bench_fwd.py``), ``attn``
(``bench_attn.py``), ``configs`` (``bench_all.py``), ``http``
(``bench_http.py``), ``host`` (``bench_host.py``) and ``scaling``
(``bench_scaling.py``).  Each prints one
JSON line per record; ``common`` holds what they share.  They run on the
card unless ``--device cpu`` is passed, and drive the port's own entry
points (``serve.__main__.build_embedder``, ``build_server``,
``warm_up``).  Nothing here imports JAX, aiohttp or the reference.
"""
