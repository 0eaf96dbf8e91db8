"""The card's peak of allocated memory over the window (GB, 1e9 bytes),
``max_memory_allocated`` after a reset at the window's start."""


def read(ctx):
    return ctx["window_peak"] / 1e9 if ctx["window_peak"] else None
