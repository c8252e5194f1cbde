"""Build the port's CUDA sources with ``nvcc`` at first use; load with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
into ``build/torch_kernels/lib<name>_<hash>.so`` at the root of the
checkout.  The hash covers the source, the shared headers and the
flags, so an edited source builds anew and an unchanged one is loaded as
it is.  ``build_all`` starts
one ``nvcc`` per source, all at once.  A failed build raises with the
compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_HERE))),
    "build", "torch_kernels")
SOURCES = ("scatter_csr.cu", "bsr_spmm.cu", "dual_sddmm.cu",
           "complex_epilogue.cu", "attend_grad.cu")
# headers the sources include: a change to one rebuilds every source
HEADERS = ("csr_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# compiler output (ptxas register / spill report) of builds in this process
BUILD_LOG: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that holds bin/nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for part in (name,) + HEADERS:
        with open(os.path.join(CSRC, part), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(name)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every source whose library is missing, all in parallel.

    Returns the seconds each compile took (empty when all were built)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    started = {}
    for name in names:
        target = library_path(name)
        if os.path.isfile(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, target, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built first if missing."""
    with _lock:
        if name not in _libs:
            build_all((name,))
            _libs[name] = ctypes.CDLL(library_path(name))
        return _libs[name]
