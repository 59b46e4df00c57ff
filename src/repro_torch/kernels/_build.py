"""Build the CUDA kernels with ``nvcc`` and bind them through ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/lib<name>.so`` at the repo root (git-ignored), at first use
(``csrc/*.cuh`` are headers the sources include):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>.so csrc/<name>.cu

A library is rebuilt when its source or any header is newer; ptxas's
register and spill report of each build is kept in ``ptxas_reports``.
Every C entry point returns ``cudaGetLastError()`` and ``check`` raises
when it is not 0.  ``csrc/pointer_chase.cu`` is a latency probe that
``chip_smoke.py`` builds beside the kernels, not a kernel of the port.
Nothing here runs at import: this module loads on hosts without ``nvcc``.

``launches`` counts kernel launches by kernel name; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show which
kernels its main path went through (``reset_launches`` before the run).
A kernel's fake form (a dry run's call, ``launch/fake.py``) launches
nothing and counts nothing there: it ``charge``s its work to the active
tallies instead.
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("walk_steps_fused", "visit_counter", "embedding_bag", "walk_hop",
           "decode_attention", "decode_attention_partial", "walk_step", "walk_bits",
           "topk_select")

launches: Dict[str, int] = {
    "walk_steps_fused": 0,
    "visit_counter_update_high": 0,
    "visit_counter_wide": 0,
    "embedding_bag": 0,
    "walk_hop_fused": 0,
    "decode_attention": 0,
    "decode_attention_partial": 0,
    "visit_counter": 0,
    "walk_step": 0,
    "walk_bits": 0,
    "topk_select": 0,
}

# per library built in this process: ptxas's register and spill lines
# for each of its kernels (from -Xptxas -v)
ptxas_reports: Dict[str, List[str]] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# the dry run's active tallies (``launch/fake.Tally``), innermost last
tallies: list = []


def charge(kernel: str, nbytes: float, ops: Dict[str, float]) -> None:
    """A hand kernel's fake form: its bytes (inputs and outputs once, its
    random reads as sectors) and its operations by type, added to every
    active tally, and one call counted there (``kernels``; real launches
    are ``launches``)."""
    for t in tallies:
        t.hbm_bytes += nbytes
        t.bytes_by_op[kernel] = t.bytes_by_op.get(kernel, 0.0) + nbytes
        for dt, n in ops.items():
            t.flops[dt] = t.flops.get(dt, 0.0) + n
        t.kernels[kernel] = t.kernels.get(kernel, 0) + 1


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
    if not lib.exists():
        return True
    inputs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


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
            ptxas_reports[name] = [
                line.split(":", 1)[-1].strip() for line in out.splitlines()
                if "registers" in line or "spill" in line
            ]
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
