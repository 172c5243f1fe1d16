"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``<checkout>/build/kernels/``, named by a hash of its source and flags, and
loaded with ``ctypes``; a later call in any process finds the library and
loads it without compiling. Importing this module compiles nothing and
needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    ``(process, temp output, final path)`` or ``None``."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: Sequence[str]) -> List[str]:
    """Compile every named source that has no library yet, all ``nvcc``
    processes at once. Returns the compilers' output (``-Xptxas -v``:
    registers, shared memory and spills of each kernel)."""
    started = [(n, _start(n)) for n in names]
    logs = []
    for name, job in started:
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
        logs.append(f"[{name}] {log}")
    return logs


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``csrc/<name>.cu``, built if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
