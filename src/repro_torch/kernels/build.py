"""Build and load the port's CUDA kernels: ``nvcc`` into shared libraries
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one ``lib<name>-<digest>.so`` under
``BUILD_DIR`` (``src/repro_torch/kernels/build/``, git-ignored), where
the digest covers the source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one loads at once.  The first
call of any kernel builds every missing library, one ``nvcc`` process
per source, all started together.  No source includes PyTorch's headers:
a wrapper passes raw pointers (``tensor.data_ptr()``) and the current
stream, and each C entry point returns ``cudaGetLastError()`` after its
launches.  Nothing here runs at import time: the CPU-only tests import
every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("commit", "coverage_matvec", "fused_select", "coins",
           "packed_count", "token_count", "ic_frontier", "flash_attention",
           "flash_attention_tc", "fm_interaction")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from src/repro_torch/kernels/csrc at first use")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names=SOURCES) -> float:
    """Compile every library in ``names`` that is missing, in parallel;
    returns the seconds spent.  Raises with the compiler's output when a
    source does not build.  The ``-Xptxas=-v`` report (registers, shared
    memory, spills) of each build is kept in ``BUILD_DIR/<name>.log``."""
    with _lock:
        t0 = time.perf_counter()
        todo = [n for n in names if not lib_path(n).exists()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = []
        for name in todo:
            out = lib_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        try:
            for name, out, tmp, proc in procs:
                log, _ = proc.communicate()
                (BUILD_DIR / f"{name}.log").write_text(log)
                if proc.returncode != 0:
                    errors.append(
                        f"--- {name}.cu (exit {proc.returncode})\n{log}")
                else:
                    os.replace(tmp, out)
        finally:
            # an interrupted build leaves no compiler running
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        return time.perf_counter() - t0


def build_logs() -> dict[str, str]:
    """The compiler reports of the last build of each source."""
    return {n: (BUILD_DIR / f"{n}.log").read_text()
            for n in SOURCES if (BUILD_DIR / f"{n}.log").exists()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it (and every
    other missing one) on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
