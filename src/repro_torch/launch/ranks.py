"""Spawn a group of ranks on one host and collect what each returns.

``run_ranks(fn, world, init_file, args)`` starts ``world`` processes with
the ``spawn`` start method (never ``fork`` once torch has started
threads); rank r calls ``fn(r, world, init_file, *args)``, where
``init_file`` is a file-store rendezvous (``file://`` + path, a path that
does not exist yet) for ``torch.distributed.init_process_group``. The
returns (anything picklable: numpy arrays, numbers) come back in rank
order. A rank that raises, dies or outlives ``timeout`` seconds makes the
call raise with every rank's error, after every process is stopped; a rank
killed by a signal prints its stacks first (``faulthandler``).
"""
from __future__ import annotations

import faulthandler
import os
import queue
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init(rank: int, world: int, init_file: str, backend: str = "gloo",
         threads: int | None = 1) -> None:
    """This rank's default process group over the file store, and
    ``threads`` intra-op CPU threads (one by default: the ranks share the
    host's cores)."""
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)


def _main(fn, rank, world, init_file, args, out, nice):
    faulthandler.enable()           # a crash prints every thread's stack
    if nice:
        os.nice(nice)
    try:
        res = fn(rank, world, init_file, *args)
        out.put((rank, True, res))
    except BaseException:                       # reported to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, init_file: str, args: tuple = (), *,
              timeout: float = 120.0, nice: int = 0) -> list:
    """``[fn(r, world, init_file, *args) for r in range(world)]``, each in
    its own spawned process (at ``nice``: a positive value leaves the
    host's other work its share of the cores); see the module
    docstring."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_main,
                         args=(fn, r, world, init_file, args, out, nice),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    errors: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"ranks {sorted(set(range(world)) - set(results))} did "
                    f"not finish within {timeout} s; errors: {errors}")
            try:
                r, ok, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                for r in dead:
                    errors[r] = f"exited with code {procs[r].exitcode}"
                continue
            (results if ok else errors)[r] = res
            if errors:
                break
        if errors:
            raise RuntimeError("rank failures:\n" + "\n".join(
                f"[rank {r}] {e}" for r, e in sorted(errors.items())))
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
