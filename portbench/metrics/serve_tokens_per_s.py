"""Output tokens of every request the window completed, over the
window's time (first wave's start to last wave's end)."""


def read(ctx):
    return ctx["n_tokens"] / ctx["window_s"]
