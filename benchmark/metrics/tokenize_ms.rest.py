"""The host's tokenization per request below the knee: the rise of the
port's ``tokenize`` phase sum over the rise of its count
(``DeviceBatcher.stats()["phases"]``, ``obs/phases.py``).  Each
request's rows are built once, on the host tokenizer pool, while the
batcher's window runs; what of it the dispatch waits for is
``prepare_wait``."""


def read(r):
    total = r.delta("batcher", "phases", "tokenize", "sum_ms")
    count = r.delta("batcher", "phases", "tokenize", "count")
    if not count:
        return None
    return total / count
