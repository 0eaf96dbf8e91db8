"""The 95th percentile of the gaps between a request's successive output
tokens, over every gap of every request of the window (ms)."""
import numpy as np


def read(ctx):
    gaps = ctx["itl_s"]
    return float(np.percentile(gaps, 95)) * 1e3 if gaps.size else None
