"""The port stands alone: every ``repro_torch`` module imports without JAX
and without anything of the reference package ``repro``, and without
``triton`` or ``nvcc`` (kernels are built at first use, never on import)."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (JAX and torch in one test process, as the suite)
import pytest
import torch  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

EXPECTED = {
    "repro_torch", "repro_torch.device", "repro_torch.convert",
    "repro_torch.core", "repro_torch.core.telemetry",
    "repro_torch.core.policy", "repro_torch.core.energy",
    "repro_torch.core.carbon", "repro_torch.core.elastic",
    "repro_torch.core.criteria", "repro_torch.core.weighting",
    "repro_torch.core.topsis", "repro_torch.core.scheduler",
    "repro_torch.core.pareto", "repro_torch.telemetry",
    "repro_torch.telemetry.export", "repro_torch.telemetry.baseline",
    "repro_torch.telemetry.report",
    "repro_torch.cluster", "repro_torch.cluster.node",
    "repro_torch.cluster.workload", "repro_torch.cluster.engine",
    "repro_torch.cluster.simulator", "repro_torch.cluster.parity",
    "repro_torch.kernels",
    "repro_torch.kernels.ops", "repro_torch.kernels.ref",
    "repro_torch.kernels.topsis_cuda", "repro_torch.kernels.cubuild",
    "repro_torch.kernels.flash_cuda", "repro_torch.kernels.rmsnorm_cuda",
    "repro_torch.models", "repro_torch.models.config",
    "repro_torch.models.layers", "repro_torch.models.lm",
    "repro_torch.configs", "repro_torch.configs.registry",
    *(f"repro_torch.configs.{arch}" for arch in (
        "mixtral_8x7b", "deepseek_v3_671b", "deepseek_coder_33b",
        "gemma_7b", "minitron_8b", "llama3_8b", "zamba2_7b", "rwkv6_1b6",
        "llama32_vision_90b", "whisper_base")),
    "repro_torch.serve", "repro_torch.serve.engine",
    "repro_torch.launch", "repro_torch.launch.serve",
    "repro_torch.launch.train", "repro_torch.optim",
    "repro_torch.optim.adamw", "repro_torch.data",
    "repro_torch.data.pipeline", "repro_torch.train",
    "repro_torch.train.loop", "repro_torch.train.checkpoint",
    "repro_torch.train.fault",
}

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""


def _probe() -> dict:
    import json
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def probe():
    return _probe()


def test_every_port_module_imports(probe):
    assert EXPECTED <= set(probe["modules"])


@pytest.mark.parametrize("forbidden", ["jax", "jaxlib", "repro", "triton"])
def test_no_forbidden_module_loaded(probe, forbidden):
    """No module of JAX, of the reference package, or of Triton is in
    ``sys.modules`` after importing the whole port in a fresh process."""
    hits = [m for m in probe["loaded"]
            if m == forbidden or m.startswith(forbidden + ".")]
    assert not hits, hits


@pytest.mark.parametrize("module", [
    "repro_torch.telemetry", "repro_torch.telemetry.export",
    "repro_torch.telemetry.baseline", "repro_torch.telemetry.report",
    "repro_torch.core.pareto"])
def test_report_modules_stand_alone(module):
    """The exporters, the report and the frontier layer, each imported
    alone in a fresh process, load nothing of JAX or of ``repro`` (the
    reference's ``repro.telemetry`` is plain Python: the port keeps its own
    copy, ``_labels_str`` included)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", f"import json, sys, {module}; "
         "print(json.dumps(sorted(sys.modules)))"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded
                if m.split(".")[0] in ("jax", "jaxlib", "repro")]


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_nothing_of_jax_or_repro(path):
    """Static check, including imports inside functions (which a fresh
    import does not execute) and chip_smoke.py."""
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}, roots
