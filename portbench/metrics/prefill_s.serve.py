"""The host's time from each wave's prefill call until its first tokens
are on the host, as a mean over the window's waves (s)."""


def read(ctx):
    t = [w.arrivals[0] - w.prefill_at for w in ctx["waves"]]
    return sum(t) / len(t)
