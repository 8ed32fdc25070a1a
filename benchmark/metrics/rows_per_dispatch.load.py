"""Requests per micro-batcher dispatch over the window: the rise of
``DeviceBatcher.stats()``'s consensus requests over the rise of its
consensus dispatches."""


def read(r):
    requests = r.delta("batcher", "requests", "consensus")
    dispatches = r.delta("batcher", "dispatches", "consensus")
    if not requests or not dispatches:
        return None
    return requests / dispatches
