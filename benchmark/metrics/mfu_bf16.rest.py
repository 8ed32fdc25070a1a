"""The model step's share of the H100's bf16 peak below the knee: the
products that the real (unpadded) tokens of the requests completed in
the window need (``cost.request_flops``), over the seconds the device
was busy in the window times 989e12, in percent.  At a fixed offered
rate the window's work is fixed, so the busy time, not the window, is
what a faster step shortens."""


def read(r):
    return r.mfu_percent(over_busy=True)
