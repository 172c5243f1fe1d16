"""ctypes binding and first-use build of the native JPEG decoder (the port's
copy of ``hgr_tpu/data/native/__init__.py``).

``load_native()`` returns the shared library compiled from
``csrc/decoder.cc`` (libjpeg decode, bicubic resize, center crop), or
``None`` when it cannot be built or loaded; ``native_status()`` then says
why. The library goes to ``<checkout>/build/kernels/`` beside the CUDA
kernels' (git-ignored), named by a hash of its source, flags and host CPU,
so a later process loads it without compiling. The ctypes call releases the
GIL, so a thread pool of decoders scales across cores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "decoder.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_status = "not loaded yet"


def _host() -> bytes:
    """The CPU that ``-march=native`` compiles for, from ``/proc/cpuinfo``."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine().encode()
    return b"".join(next((x for x in lines if x.startswith(k)), b"")
                    for k in (b"model name", b"flags"))


def library_path() -> Path:
    """Keyed by the source, the flags and the host CPU, so a checkout
    shared between machines never loads another CPU's build."""
    key = SRC.read_bytes() + " ".join(FLAGS).encode() + _host()
    return BUILD_DIR / f"libdecoder-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """``g++ ... decoder.cc -ljpeg`` into a temporary file, renamed into
    place, so a concurrent builder sees all or nothing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        p = subprocess.run(["g++", *FLAGS, str(SRC), "-o", tmp, "-ljpeg"],
                           capture_output=True, text=True, timeout=120)
        if p.returncode != 0:
            raise RuntimeError(p.stderr.strip().splitlines()[-1] if p.stderr else "g++ failed")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_native():
    """-> ctypes CDLL with ``hgr_decode_resize_u8``, or None (see
    ``native_status``)."""
    global _lib, _status
    with _lock:
        if _lib is not None or _status != "not loaded yet":
            return _lib
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:  # no g++ or libjpeg
            _status = f"unavailable: {type(e).__name__}: {e}"
            return None
        lib.hgr_decode_resize_u8.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                                             ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib.hgr_decode_resize_u8.restype = ctypes.c_int
        _lib = lib
        _status = f"native libjpeg decoder {out.name}"
        return _lib


def native_status() -> str:
    """What ``load_native`` found: the library's name, or why there is none."""
    return _status


def decode_resize_u8(jpeg_bytes: bytes, out_px: int) -> Optional[np.ndarray]:
    """One JPEG -> [out_px, out_px, 3] uint8 (resize and crop, normalised on
    the device), or None."""
    lib = load_native()
    if lib is None:
        return None
    buf = np.frombuffer(jpeg_bytes, dtype=np.uint8)
    out = np.empty((out_px, out_px, 3), np.uint8)
    rc = lib.hgr_decode_resize_u8(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_long(len(jpeg_bytes)),
        ctypes.c_int(out_px),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None
