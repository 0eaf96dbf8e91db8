"""End-to-end serving on the PyTorch port: batched requests through the
wave engine (prefill + KV-cache decode) on a reduced model on the card.
The model runs with ``attn_impl="flash"``: every prefill's attention takes
kernel K5 (the SMOKE config's head dim 8 padded to 32). The port's
counterpart of ``examples/serve_lm.py``.

Run: PYTHONPATH=src python examples/torch_serve_lm.py [--requests 12]
         [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.serve.engine import Engine, Request


def main(argv=None, *, params=None, wrap=None) -> dict:
    """Serve the requests, print the rate and return the results.
    ``params`` (numpy arrays in the reference's parameter tree) replace
    the seeded weights; ``wrap(model)`` gives what the engine calls
    instead of the model (a recorder of its calls, say)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    cfg = registry.smoke_config(args.arch, attn_impl="flash")
    model = (LM(cfg, device=dev, seed=0) if params is None
             else lm_params_from_numpy(cfg, params, device=dev))
    eng = Engine(wrap(model) if wrap else model, batch_slots=args.slots,
                 max_len=64)

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(2, cfg.vocab, rng.integers(4, 12))
                    .astype(np.int32), max_new_tokens=args.max_new)
            for i in range(args.requests)]

    t0 = time.perf_counter()
    results = eng.serve(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in results)
    print(f"served {len(results)} requests in {dt:.2f}s "
          f"({args.slots} slots/wave): {n_tok} tokens, "
          f"{n_tok / dt:.1f} tok/s on {dev}")
    for r in results[:5]:
        print(f"  req {r.uid}: {len(r.tokens)} tokens -> {r.tokens[:8]}...")
    return {"device": str(dev), "requests": len(results), "tokens": n_tok,
            "seconds": dt, "tokens_per_s": n_tok / dt,
            "results": {r.uid: np.asarray(r.tokens) for r in results}}


if __name__ == "__main__":
    main()
