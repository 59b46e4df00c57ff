"""Build the CUDA kernels with ``nvcc`` and bind them through ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/lib<name>.so`` at the repo root (git-ignored), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>.so csrc/<name>.cu

A library is rebuilt when its source is newer.  Every C entry point
returns ``cudaGetLastError()`` and ``check`` raises when it is not 0.
Nothing here runs at import: this module loads on hosts without ``nvcc``.

``launches`` counts kernel launches by kernel name; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show which
kernels its main path went through (``reset_launches`` before the run).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
SOURCES = ("walk_steps_fused", "visit_counter")

launches: Dict[str, int] = {
    "walk_steps_fused": 0,
    "visit_counter_update_high": 0,
    "visit_counter_wide": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a CUDA host")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return not lib.exists() or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


def build(names: Iterable[str] = SOURCES) -> List[str]:
    """Compile every stale source, one ``nvcc`` each, all started
    together; returns the names that were built.  Each library is written
    to a temporary file and renamed into place, so a reader never loads a
    half-written one."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, tmp, proc))
    errors = []
    for name, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {name}.cu:\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")
