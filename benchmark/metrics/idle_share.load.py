"""The device's idle share: 1 - the union of the profiled device
intervals over the traced window."""


def read(r):
    return r.idle_share()
