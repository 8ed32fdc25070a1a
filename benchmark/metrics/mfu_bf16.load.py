"""The model step's share of the H100's bf16 peak above the knee: the
products that the real (unpadded) tokens of the requests completed in
the window need (``cost.request_flops``), over the window's seconds
times 989e12, in percent."""


def read(r):
    return r.mfu_percent()
