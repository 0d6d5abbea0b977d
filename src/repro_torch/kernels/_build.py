"""nvcc -> shared library -> ctypes, for the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own for ``sm_90a`` into
``build/kernels/<name>-<hash>.so`` at the root of the checkout, where the
hash is of the source and the headers it shares (``csrc/*.cuh``), so an
edited kernel is rebuilt and a stale library is never loaded. Nothing is built when a module is imported: the first call
that needs a kernel builds it, and ``build_all`` builds every kernel at once
with one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["SOURCES", "build_all", "library"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("binary_ip", "topk_select", "merge_topk", "cluster_scan",
           "flash_attn", "flash_decode", "beam_search")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> pathlib.Path:
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Build every listed kernel that is not built yet, in parallel.

    Returns {name: ptxas report} for the kernels built by this call (the
    registers, shared memory and spills of each kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)       # atomic: concurrent builds never clash
        reports[name] = log
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built at first use."""
    with _lock:
        if name not in _libs:
            build_all((name,))
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
