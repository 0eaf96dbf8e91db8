"""Serving entry point of the port: wave-batched prefill + decode engine —
counterpart of ``repro.launch.serve``, with ``--device`` (default: the card).
The model runs with ``attn_impl="flash"``, so prefill attention goes through
the flash-attention kernel (K5) on the card and its plain version on the CPU
(mixtral-8x7b with its 4096-token sliding window); deepseek-v3-671b's MLA
takes no kernel (the reference's MLA calls ``_sdpa``). whisper-base's
encoder and decoder prefill take K5 (the encoder bidirectional), and
llama-3.2-vision-90b's dense blocks; like the reference's CLI it passes no
``frames`` / ``vision``, so their cross-attention reads zeros. zamba2-7b's
shared attention block takes K5 in every group's prefill (head dim 112,
padded to 128); its Mamba2 blocks and rwkv6-1.6b take no kernel.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --smoke \\
      --requests 16 --slots 4 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = (registry.smoke_config(args.arch, attn_impl="flash") if args.smoke
           else registry.config(args.arch, attn_impl="flash"))
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    model = LM(cfg, device=dev, seed=0)
    eng = Engine(model, batch_slots=args.slots, max_len=args.max_len)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(2, cfg.vocab,
                                    rng.integers(4, args.max_len // 4))
                    .astype(np.int32), max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    results = eng.serve(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in results)
    print(f"served {len(results)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s) on {dev}")
    return results


if __name__ == "__main__":
    main()
