"""The profiler's reading of one traced stretch of device work.

``Stretch`` runs ``torch.profiler`` over the device alone (CUDA
activity: no host events, whose recording would slow a loop the host
paces and so read the profiler's cost as idle time) from a synchronised
start to a synchronised stop. Its window is the host's clock between
the two synchronisations, taken outside the profiler, so every device
operation of the stretch lies inside it. From the raw Kineto events
(not the profiler's event tree, which takes minutes to build for a
wave's hundred thousand kernels) it reads:

* ``window_s``: the window's length;
* ``busy_s``: the union of every device operation (kernels, copies,
  sets) in it;
* ``ops``: device seconds and calls by operation name;
* ``idle``: the device's idle time in the window by what ended it:
  ``before <op>`` for a gap between two operations (the host was
  preparing that operation), ``edges`` for the rest of the window.
"""
from __future__ import annotations

import collections
import time

import torch


class Stretch:
    def __init__(self):
        self.prof, self.reading = None, None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.reading = read(self.prof.profiler.kineto_results.events(),
                            window_s)
        self.prof = None

    @property
    def running(self) -> bool:
        return self.prof is not None


def read(events, window_s: float) -> dict:
    device = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                     ev.name()) for ev in events
                    if ev.device_type() == torch.autograd.DeviceType.CUDA)
    if not device:
        return {}
    ops = collections.defaultdict(lambda: [0.0, 0])
    idle = collections.defaultdict(float)
    busy, cursor = 0, device[0][0]
    for s, e, name in device:
        ops[name][0] += (e - s) / 1e9
        ops[name][1] += 1
        if s > cursor:
            idle[f"before {name}"] += (s - cursor) / 1e9
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    idle["edges"] = max(window_s - (cursor - device[0][0]) / 1e9, 0.0)
    return {"window_s": window_s, "busy_s": busy / 1e9,
            "ops": {k: tuple(v) for k, v in ops.items()},
            "idle": dict(idle)}


def breakdown(readings: dict, n: int = 10) -> dict:
    """The ``breakdown`` of a result line from readings by stretch name:
    the device operations that took the most time and the idle time by
    what ended it, at most ``n`` of each, each named ``<stretch>: ...``."""
    ops = [(f"{k}: {op}", v[0]) for k, r in readings.items()
           for op, v in r.get("ops", {}).items()]
    idle = [(f"{k}: {what}", v) for k, r in readings.items()
            for what, v in r.get("idle", {}).items()]
    return {"device_ops": [[k[:160], v] for k, v in
                           sorted(ops, key=lambda kv: -kv[1])[:n]],
            "idle_gaps": [[k[:160], v] for k, v in
                          sorted(idle, key=lambda kv: -kv[1])[:n]]}
