"""Build and load one CUDA source of ``csrc/`` as a plain-C shared library.

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` (no
PyTorch headers: seconds, not minutes), cached under ``build/`` at the
repository root by a hash of the source, every header of ``csrc/`` and
the flags, and loaded with ``ctypes``. Nothing is built when a module is
imported.

``CudaLibrary.start()`` launches ``nvcc`` without waiting, so a caller that
needs several libraries starts every build first and then ``load()``s each:
the compilers run side by side.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes argument types of the C entry points: pointers and the stream as
# c_void_p (a Python int would be cut to 32 bits), sizes, strides and
# codes as c_int or c_int64, scalars as c_float.
PTR, I32, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_float)


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are compiled at first use")


class CudaLibrary:
    """``csrc/<stem>.cu`` built into ``build/repro_torch/lib<stem>_<hash>.so``.

    ``signatures`` maps each C entry point to its ctypes argument types;
    every entry point returns an ``int`` CUDA error code, and
    ``<stem>_error_string(int)`` names it."""

    def __init__(self, stem: str, signatures: dict[str, list]):
        self.stem = stem
        self.source = CSRC / f"{stem}.cu"
        self.signatures = signatures
        self.lib: ctypes.CDLL | None = None
        self.path: Path | None = None
        self.build_seconds = 0.0
        self.ptxas_log = ""
        self._proc: subprocess.Popen | None = None
        self._t0 = 0.0

    def _target(self) -> Path:
        """The library's path, keyed by the source, every ``csrc/*.cuh``
        (a source may include any of them) and the flags."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.stem}_{h.hexdigest()[:16]}.so"

    def start(self) -> "CudaLibrary":
        """Launch ``nvcc`` for this source unless it is built, building or
        loaded; returns at once."""
        if self.lib is not None or self._proc is not None:
            return self
        self.path = self._target()
        self._t0 = time.perf_counter()
        if not self.path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            self._tmp = self.path.with_name(f"{self.path.name}."
                                            f"{os.getpid()}.tmp")
            self._proc = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(self._tmp), str(self.source)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return self

    def load(self) -> "CudaLibrary":
        """Wait for the build (starting it if need be) and load the
        library once per process."""
        if self.lib is not None:
            return self
        self.start()
        log_path = self.path.with_suffix(".ptxas.txt")
        if self._proc is not None:
            out, err = self._proc.communicate()
            rc, self._proc = self._proc.returncode, None
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}) on {self.source}:"
                                   f"\n{out}\n{err}")
            log_path.write_text(out + err)
            os.replace(self._tmp, self.path)
        self.build_seconds = time.perf_counter() - self._t0
        self.ptxas_log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(self.path))
        for name, argtypes in self.signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.stem}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        self.lib = lib
        return self

    def call(self, name: str, *args) -> None:
        """Launch entry point ``name``; raise on a CUDA error code."""
        rc = getattr(self.load().lib, name)(*args)
        if rc != 0:
            msg = getattr(self.lib, f"{self.stem}_error_string")(rc).decode()
            raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                               f"({msg})")


def stream(device: torch.device) -> tuple[int, int]:
    """(device index, current CUDA stream handle) for a launch."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"tensors on {x.device} are not supported; use cuda "
                     f"(the kernels) or cpu (their plain versions)")
