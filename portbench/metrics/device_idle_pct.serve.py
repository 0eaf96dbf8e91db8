"""The share of the traced wave's steady decode steps (the driver's
``TRACED_DECODE``, device activity profiled alone) in which no operation
ran on the card (%): the window is the host's clock between synchronised
ends, the busy time the union of the profiled device operations."""


def read(ctx):
    r = ctx["readings"].get("decode")
    if not r:
        return None
    return 100 * (1 - r["busy_s"] / r["window_s"])
