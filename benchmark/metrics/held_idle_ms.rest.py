"""The device's idle time while a request is held, per request below the
knee: the rise of the port's ``held_idle`` phase sum over the rise of
its count (``DeviceBatcher.stats()["phases"]``, ``obs/phases.py``).
Each ``/consensus`` answered 200 observes its door-to-last-byte time
less the union of the dispatches' launch-to-ready intervals in it: the
inside counterpart of ``host_ms.rest``."""


def read(r):
    total = r.delta("batcher", "phases", "held_idle", "sum_ms")
    count = r.delta("batcher", "phases", "held_idle", "count")
    if not count:
        return None
    return total / count
