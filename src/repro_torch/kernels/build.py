"""Build the port's CUDA kernels and load them with ``ctypes``.

Each source under ``repro_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface (no
PyTorch headers, so one build takes seconds).  Libraries land in
``<repo>/build/kernels`` named by the SHA-256 of the source and of the
headers the sources share (``csrc/*.cuh``), so a library is rebuilt when
either is edited and reused otherwise.  Nothing is compiled at import
time: :func:`library` builds on first use, :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gram", "attn_colsum", "quant_matmul", "flash_decode",
           "mla_decode", "hadamard", "gptq_block", "ldlq_block")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    sha = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.name.encode())
        sha.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{sha.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built.
    Returns (target, process or None, log path)."""
    target = _target(name)
    log = target.with_suffix(".log")
    if target.exists():
        return target, None, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return target, (proc, tmp), log


def _finish(name: str, target: Path, job, log: Path) -> None:
    if job is None:
        return
    proc, tmp = job
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log.read_text()}")
    os.replace(tmp, target)


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every named source in parallel (one nvcc each).

    Returns {"seconds": wall time, <name>: 1.0 if built now else 0.0}."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    out = {}
    for n, (target, job, log) in jobs.items():
        _finish(n, target, job, log)
        out[n] = 0.0 if job is None else 1.0
    out["seconds"] = time.perf_counter() - t0
    return out


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    last build of ``name``, or '' when it was reused from an earlier run."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """Load (building first if needed) the shared library of ``name``."""
    lib = _LIBS.get(name)
    if lib is None:
        target, job, log = _start(name)
        _finish(name, target, job, log)
        lib = ctypes.CDLL(str(target))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a non-zero ``cudaGetLastError``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
