"""The micro-batcher's queue wait per request below the knee: the rise
of the port's ``batcher_queue`` phase sum (an item's submit to its group
taking the device, the accumulation window included) over the rise of
its count (``DeviceBatcher.stats()["phases"]``, ``obs/phases.py``)."""


def read(r):
    total = r.delta("batcher", "phases", "batcher_queue", "sum_ms")
    count = r.delta("batcher", "phases", "batcher_queue", "count")
    if not count:
        return None
    return total / count
