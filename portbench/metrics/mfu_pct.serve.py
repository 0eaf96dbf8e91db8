"""The model's FLOPs of every request served in the window (its prompt
without padding, its output tokens, attention over its own valid pairs:
``harness.work.served_flops``) over the window's time, as a share of one
card's bf16 peak (%)."""
from harness import work


def read(ctx):
    c = ctx["config"]
    flops = sum(work.served_flops(c, len(r.prompt), len(w.tokens[r.client]))
                for w in ctx["waves"] for r in w.reqs if r.client in w.tokens)
    return 100 * flops / ctx["window_s"] / work.BF16_FLOPS
