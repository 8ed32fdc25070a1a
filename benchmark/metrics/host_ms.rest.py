"""The host's part of a request at rest (one client): the client's p50
latency minus the profiled device time per request (the union of the
window's device intervals over the requests completed in it)."""


def read(r):
    p50 = r.p50_ms()
    if p50 is None or not r.trace["device"]:
        return None
    return p50 - 1e3 * r.trace["busy_s"] / len(r.completed)
