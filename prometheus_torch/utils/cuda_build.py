"""Build the hand-written CUDA sources under ``csrc/`` and bind them.

Each source is compiled by ``nvcc`` on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and loaded
with ``ctypes``. Libraries land in ``build/prometheus_torch/`` at the root
of the checkout, named after the source's content hash, so an edited source
rebuilds and an unchanged one is reused. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "prometheus_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


class CudaKernel:
    """One C entry point of a ``csrc/`` source, built at first use.

    The C function returns ``cudaGetLastError()`` after its launch;
    ``launch`` raises if that is not 0 and otherwise adds one to
    ``launches``, the count a run reads to show it went through the kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self._fn = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):   # what sources include
            digest.update(header.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{digest.hexdigest()[:16]}.so"

    def _load(self):
        path = self.library_path()
        if not path.exists():
            build([self])
        fn = getattr(ctypes.CDLL(str(path)), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, *args) -> None:
        fn = self._fn or self._load()
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1


def build(kernels: list[CudaKernel]) -> None:
    """Compile the sources of ``kernels`` that are not built yet, one
    ``nvcc`` process per source, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for kern in {k.source: k for k in kernels}.values():
        out = kern.library_path()
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(kern.source)]
        procs.append((kern, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for kern, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        kern.build_seconds = time.perf_counter() - t0
        kern.build_log = log
        if proc.returncode != 0:
            failed.append(f"{kern.source.name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
