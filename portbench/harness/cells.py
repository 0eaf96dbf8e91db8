"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

A cell names a configuration (``configs/<file>`` as ``BENCHMARK.json``
gives it) and a traffic mix (``traffic/<traffic>.json``). The traffic
file names the path driver (``drivers/<driver>.py``), each metric has a
reader (``metrics/<metric>.py``), and the cell's limits on what decides
``correct`` are in ``limits/<cell>.json``. A later cell, mix, driver or
metric is a file added beside these; nothing here changes for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def driver(self):
        return load_module(BENCH / "drivers" / f"{self.traffic['driver']}.py")


def load_module(path: Path):
    """The module in ``path``, loaded by its file name (a reader's name
    may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell called ``name`` with its configuration, traffic, limits and
    the metrics it reports."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((REPO / cfg["file"]).read_text()),
        traffic=json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return load_module(BENCH / "metrics" / f"{metric}.py").read
