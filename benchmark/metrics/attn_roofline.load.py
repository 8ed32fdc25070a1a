"""The attention kernel's share of its roofline: the least time the
card could take for the traced launches (at each launch's shape, from
the frozen FLOP and byte count) over their profiled time, in percent."""


def read(r):
    return r.attention_roofline_percent()
