"""K5 (``flash_fwd_kernel``) in the traced wave's prefill: the sum of its calls'
bounds (``harness.work.flash_fwd_bound_s`` at the wave's padded prefill
shape, one call a layer) over the sum of their device times (%). Nothing
where the trace holds no such kernel, or not one call a layer."""
from harness import work
from harness.weights import dims

KERNEL = "flash_fwd_kernel"


def read(ctx):
    r = ctx["readings"].get("prefill")
    if not r:
        return None
    hits = [v for k, v in r["ops"].items() if KERNEL in k]
    seconds, calls = sum(v[0] for v in hits), sum(v[1] for v in hits)
    z, c = dims(ctx["config"]), ctx["config"]
    if calls != z["L"] or seconds <= 0:
        return None
    s = max(len(r.prompt) for r in ctx["traced_reqs"])
    b = len(ctx["traced_reqs"])
    bound = work.flash_fwd_bound_s(b, z["H"], z["Hkv"], s, z["hd"],
                                   c.get("sliding_window"))
    return 100 * calls * bound / seconds
