"""Fault tolerance: supervised training with checkpoint/restart and
straggler detection — port of ``repro.train.fault``.

The supervisor wraps the train loop; any step may raise (a hardware fault
is simulated by an injected callback in tests). Recovery = restore the
latest checkpoint (elastically, onto the mesh of ``shardings`` when given)
and continue. Across ranks every rank runs the loop; a fault must reach
every rank at the same step. Straggler mitigation: per-step wall times
(the host clock after the card has finished the step) feed an EWMA; a step
slower than ``straggler_factor`` x EWMA raises a StragglerAlert that the
fleet layer answers by re-running TOPSIS placement for the slow slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.train import checkpoint


class StragglerAlert(RuntimeError):
    def __init__(self, step: int, t: float, ewma: float):
        super().__init__(f"step {step}: {t:.3f}s vs ewma {ewma:.3f}s")
        self.step, self.t, self.ewma = step, t, ewma


def _synchronize(tree) -> None:
    """Wait for the card where ``tree`` holds CUDA tensors, so that a
    step's wall time is the step's and not its enqueue."""
    for leaf in checkpoint._flatten(tree).values():
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


@dataclasses.dataclass
class Supervisor:
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    on_straggler: Callable[[StragglerAlert], None] | None = None

    def run(self, *, state: dict[str, Any], step_fn, data_fn, n_steps: int,
            fault_hook=None, shardings=None):
        """state: {"params": ..., "opt_state": ...}; step_fn(params,
        opt_state, batch) -> (params, opt_state, metrics); data_fn(step) ->
        batch. Returns (final state, history). fault_hook(step) may raise to
        simulate node failure. ``shardings`` (the state's structure, a
        ``rules.NamedSharding`` at each tensor leaf) lays every restored
        state out on its mesh, at the start and on every restart."""
        restarts = 0
        pending: list = []
        history: list[dict] = []
        start = checkpoint.latest_step(self.ckpt_dir)
        step = 0
        if start is not None:
            state = checkpoint.restore(self.ckpt_dir, start, state,
                                       shardings)
            step = start
        ewma = None
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                if fault_hook is not None:
                    fault_hook(step)
                batch = data_fn(step)
                p, o, m = step_fn(state["params"], state["opt_state"], batch)
                state = {"params": p, "opt_state": o}
                _synchronize(m)
                dt = time.perf_counter() - t0
                ewma = dt if ewma is None else (
                    self.ewma_alpha * dt + (1 - self.ewma_alpha) * ewma)
                if dt > self.straggler_factor * ewma and step > 2:
                    alert = StragglerAlert(step, dt, ewma)
                    if self.on_straggler:
                        self.on_straggler(alert)
                history.append({"step": step, "time_s": dt,
                                **{k: float(v) for k, v in m.items()}})
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    pending.append(checkpoint.save(
                        self.ckpt_dir, step, state, blocking=False))
            except StragglerAlert:
                raise
            except Exception:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                # land in-flight async saves before looking for the latest
                # checkpoint, else a crash right after a non-blocking save
                # restarts from a stale (or no) checkpoint
                for t in pending:
                    if t is not None:
                        t.join()
                pending.clear()
                checkpoint.barrier()   # rank 0's writes land for all
                last = checkpoint.latest_step(self.ckpt_dir)
                if last is not None:
                    state = checkpoint.restore(self.ckpt_dir, last, state,
                                               shardings)
                    step = last
                else:
                    step = 0
        # drain async writers, then a final blocking checkpoint so
        # restore-after-run is deterministic
        for t in pending:
            if t is not None:
                t.join()
        checkpoint.save(self.ckpt_dir, step, state, blocking=True)
        return state, history
