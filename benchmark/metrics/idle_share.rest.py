"""The device's idle share below the knee: 1 - the union of the
profiled device intervals over the traced window.  At a fixed offered
rate it is 1 - rate x device time per request, so a shorter step raises
it."""


def read(r):
    return r.idle_share()
