"""The gateway's own time per request below the knee: the rise of the
port's ``gateway_read`` (the body read, parsed and validated, the item
submitted) and ``gateway_write`` (the answer encoded and written to its
last byte) phase sums over the rise of the batcher's consensus requests
(``DeviceBatcher.stats()``, ``obs/phases.py``)."""


def read(r):
    requests = r.delta("batcher", "requests", "consensus")
    read_ms = r.delta("batcher", "phases", "gateway_read", "sum_ms")
    write_ms = r.delta("batcher", "phases", "gateway_write", "sum_ms")
    if not requests or read_ms is None or write_ms is None:
        return None
    return (read_ms + write_ms) / requests
