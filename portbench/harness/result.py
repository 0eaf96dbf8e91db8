"""The run's last line, and what must hold before it is printed."""
from __future__ import annotations

import json
import sys

import torch

# top-level module names the process must not hold once the window has
# closed: the JAX stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def device(count: int, memory_peak_bytes: int, reading: dict | None = None
           ) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(memory_peak_bytes)}
    if reading:
        out["busy_s"] = reading["busy_s"]
        out["window_s"] = reading["window_s"]
    return out


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def emit(line: dict, checks: dict) -> None:
    """Print every compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output,
    with the same numbers under ``checks``, its last key."""
    for name, c in checks.items():
        print(f"check {name}={c['value']!r} limit={c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**line, "checks": checks}), flush=True)
